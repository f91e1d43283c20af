// What the flash attention kernels share (flash_attention.cu on the CUDA
// cores, flash_attention_tc.cu on the tensor cores): the strides and the
// shape of a call, the causal / window mask of one (query, key) pair, and
// the key tiles a query tile sees and the query tiles a key tile reaches,
// by which both skip the work outside the mask.
#pragma once

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

enum Tensor { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kNumTensors };

// (batch, head, sequence) strides in elements of the tensors of a call,
// indexed by Tensor (the forward fills the first four)
struct Strides {
  long long v[kNumTensors][3];
  __device__ __forceinline__ int64_t off(int t, int b, int h) const {
    return b * v[t][0] + h * v[t][1];
  }
  __device__ __forceinline__ int64_t seq(int t) const { return v[t][2]; }
};

struct Shape {
  int heads, kv_heads, sq, sk;
  int d;  // head size: the tile width D, or less (a zero tail)
  float scale;
  int causal;
  int window;  // a query sees its last `window` positions; 0 = no window
  // segment ids (batch, sq) and (batch, sk) int32, contiguous; null for
  // none
  const int* qseg;
  const int* kseg;
};

// The causal and window masks of one (query, key) pair (segments apart).
__device__ __forceinline__ bool visible(const Shape& sh, int qpos, int kpos) {
  const int back = qpos + sh.sk - sh.sq - kpos;  // how far the key lies back
  return kpos < sh.sk && (!sh.causal || back >= 0) &&
         (sh.window == 0 || back < sh.window);
}

struct TileRange {
  int lo, hi;
};

// Key tiles [lo, hi) of width bk that a query tile [q0, q0 + bq) can see:
// the causal diagonal ends the range, and the window's lower edge starts
// it (a key tile wholly before its first query's band is dead for every
// query of the tile, as _fwd_kernel's window skip).
__device__ __forceinline__ TileRange key_tiles(const Shape& sh, int q0,
                                               int bq, int bk) {
  const int off = sh.sk - sh.sq;
  TileRange r{0, (sh.sk + bk - 1) / bk};
  if (sh.causal) {
    const int last = q0 + bq - 1 + off;
    r.hi = last < 0 ? 0 : min(r.hi, last / bk + 1);
  }
  if (sh.window) {
    const int first = q0 + off - sh.window + 1;  // first query's first key
    r.lo = first > 0 ? first / bk : 0;
  }
  return r;
}

// Query tiles [lo, hi) of height bq whose rows see some key of the key
// tile [k0, k0 + bk): causally the rows from k0 - off on, and in a window
// the rows up to the one whose band still reaches the tile's last key.
__device__ __forceinline__ TileRange query_tiles(const Shape& sh, int k0,
                                                 int bk, int bq) {
  const int off = sh.sk - sh.sq;
  TileRange r{0, (sh.sq + bq - 1) / bq};
  if (sh.causal) {
    const int need = k0 - off - bq + 1;
    r.lo = need > 0 ? (need + bq - 1) / bq : 0;
  }
  if (sh.window) {
    const int qlast = min(k0 + bk, sh.sk) - 1 + sh.window - 1 - off;
    r.hi = qlast < 0 ? 0 : min(r.hi, qlast / bq + 1);
  }
  return r;
}

// The checks every C entry makes, and the strides of its n_tensors
// tensors into *st.
cudaError_t check_args(int device, int batch, const Shape& sh, int d,
                       const long long* strides, int n_tensors,
                       Strides* st) {
  cudaError_t e = pt::set_device(device);
  if (e != cudaSuccess) return e;
  if (batch < 0 || sh.heads <= 0 || sh.kv_heads <= 0 ||
      sh.heads % sh.kv_heads != 0 || sh.sq < 0 || sh.sk < 0 ||
      sh.window < 0 || (sh.qseg == nullptr) != (sh.kseg == nullptr) ||
      d != sh.d || d <= 0 || sh.heads > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  for (int t = 0; t < kNumTensors; ++t)
    for (int i = 0; i < 3; ++i)
      st->v[t][i] = t < n_tensors ? strides[t * 3 + i] : 0;
  return cudaSuccess;
}

}  // namespace
