// Grouped expert product (X1) for Hopper (sm_90a): the dropless MoE
// layer's expert GEMM over rows sorted by expert.
//
// Replaces XLA's lax.ragged_dot at paddle_tpu/distributed/moe.py:104-106
// (not a Pallas kernel: the JAX package leaves the grouped product to
// XLA):
//
//   y[r, n] = sum_k x[r, k] * w[e, k, n]  for offsets[e] <= r < offsets[e+1]
//
// x (R, K) with its rows sorted by expert and w (E, K, N) contiguous, both
// bf16 or both float32; offsets (E + 1) int32 on the device, nondecreasing,
// offsets[0] = 0 and offsets[E] = R (an exclusive scan of the group sizes);
// float32 sums; y (R, N) in x's dtype.
//
// Nothing is read on the host. The grid comes from R and E only:
// ceil(R / BM) + min(E, R) row-tile slots, an upper bound on the (expert,
// tile) pairs (sum_e ceil(c_e / BM) <= R / BM + the experts with rows),
// times ceil(N / BN) column strips. Each block finds its pair by a warp's
// scan of the offsets staged in shared memory, and a block past the last
// pair exits. So a product is one launch whatever the routing, and the
// launch can be captured in a CUDA graph and replayed after the routing
// changes. An expert with no rows costs only the scan.
//
// Bound: at decode sizes (R = T * k rows: 6 at batch 1, 48 at batch 8 for
// top 6) bytes, the K x N weight slab of each expert that has rows, read
// once. The skinny path (the wrapper takes it while R <= E in bf16, 8 E in
// float32) gives a block one expert's tile of up to 4 rows and a strip of
// 64 (bf16) or 32 (float32) columns. Its 256 threads are 8 column lanes x
// 32 K lanes, and a lane takes 8 consecutive weight rows a step: it issues
// their 8 16-byte loads (a warp reads 4 rows x 128 consecutive bytes at a
// time) and its 16-byte loads of the tile's x rows over the same 8 columns
// of K (L1 / L2 hits, shared by the 8 column lanes) before it uses any, so
// a block keeps 32 KB of weights in flight with no shared-memory staging
// and no barrier in its loop. The K lanes' sums are added by shuffles
// inside a warp, then across the 8 warps in shared memory in a fixed
// order: no atomics, so the result does not change from run to run. A
// column tail past N, or an N that does not keep the rows 16-byte
// aligned, takes scalar loads; so does x when K is not a multiple of 8.
//
// The tiled path computes 64 x 64 output tiles over 16-wide K steps, x
// and w staged in shared memory as float32 (the next step's loads issued
// into registers before the current step's FMAs), 4 x 4 outputs a
// thread, on the CUDA cores. It takes the rows past the skinny path that
// the tensor cores do not (moe_grouped_matmul_tc.cu takes bf16 prefill
// rows): float32, which TF32 would round, and bf16 with K or N not a
// multiple of 8 or unaligned pointers.
//
// With trans_w both paths compute the backward's dx = dy w[e]^T (the VJP
// of ragged_dot in x, which XLA supplies to the JAX package) over the
// forward's weight as it lies, (E, N, K) in these kernels' names: no
// transposed copy of the expert weights is made. The skinny path's
// weight rows then run along K, so each warp owns 8 output columns and
// its 32 lanes stride over K by 16-byte loads of those 8 weight rows and
// of the tile's x rows; a fixed shuffle tree adds the lanes. The tiled
// path stages w[e]'s (N, K) tile as it stages x's, one 16-wide K slice
// of 64 rows. The wrapper picks dx's route by the forward's rule.

#include "common.cuh"
#include "moe_grouped_matmul.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSkinnyRows = 4;          // rows a skinny block owns
constexpr int kLanesN = 8;              // column lanes of a skinny block
constexpr int kLanesK = kThreads / kLanesN;
constexpr int kRowsK = 8;               // consecutive K rows a lane takes
constexpr int kTileM = 64, kTileN = 64, kTileK = 16;
constexpr int kColsWarp = 8;            // columns a warp owns, trans_w skinny

// n elements of T from p (16-byte aligned, n * sizeof(T) a multiple of
// 16) by 16-byte loads
template <typename T, int n>
__device__ __forceinline__ void ldg16(pt::Pack<T, n>& out,
                                      const T* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(n * sizeof(T) / 16); ++i)
    reinterpret_cast<int4*>(&out)[i] =
        __ldg(reinterpret_cast<const int4*>(p) + i);
}

// V consecutive elements of a weight row from column n0: one 16-byte load
// when the row keeps 16-byte alignment and the V columns exist, else one
// element at a time (zero past N, or for a row past K)
template <typename T, int V>
__device__ __forceinline__ void load_w(pt::Pack<T, V>& out,
                                       const T* __restrict__ row, int n0,
                                       int N, bool valid, bool vec_ok) {
  if (valid && vec_ok && n0 + V <= N) {
    ldg16<T, V>(out, row + n0);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      out.v[v] = (valid && n0 + v < N) ? row[n0 + v] : pt::from_f32<T>(0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ offsets, T* __restrict__ y,
                      int K, int N, int E, bool vec_ok) {
  constexpr int V = 16 / sizeof(T);      // columns a lane loads at once
  constexpr int BN = kLanesN * V;
  constexpr int kWarps = kThreads / 32;
  constexpr int kStep = kLanesK * kRowsK;  // K rows a block takes a step
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ Pair s_pair;
  __shared__ float red[kWarps][kSkinnyRows][BN];
  if (!find_pair(offsets, E, kSkinnyRows, blockIdx.x, s_off, &s_pair))
    return;
  const int r0 = s_pair.r0, rows = s_pair.r1 - s_pair.r0;
  const int tid = threadIdx.x, c = tid % kLanesN, kl = tid / kLanesN;
  const int n0 = blockIdx.y * BN + c * V;
  const T* __restrict__ we = w + static_cast<size_t>(s_pair.e) * K * N;
  // x's rows by 16-byte loads when every row and every step start keeps
  // 16-byte alignment
  const bool x_vec = (K % kRowsK == 0) &&
                     (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  float acc[kSkinnyRows][V];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  for (int k0 = kl * kRowsK; k0 < K; k0 += kStep) {
    // every load of the step first: kRowsK weight rows (kept packed), then
    // the tile's rows of x over the same kRowsK columns (rows past the
    // tile read as 0, so every row's FMAs run without a branch)
    pt::Pack<T, V> wr[kRowsK];
#pragma unroll
    for (int i = 0; i < kRowsK; ++i)
      load_w<T, V>(wr[i], we + static_cast<size_t>(k0 + i) * N, n0, N,
                   k0 + i < K, vec_ok);
    float xv[kSkinnyRows][kRowsK];
#pragma unroll
    for (int r = 0; r < kSkinnyRows; ++r) {
      const T* __restrict__ xr = x + static_cast<size_t>(r0 + r) * K + k0;
      if (r < rows && x_vec) {
        pt::Pack<T, kRowsK> p;
        ldg16<T, kRowsK>(p, xr);
#pragma unroll
        for (int i = 0; i < kRowsK; ++i) xv[r][i] = pt::to_f32(p.v[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kRowsK; ++i)
          xv[r][i] = (r < rows && k0 + i < K) ? pt::to_f32(xr[i]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsK; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float wf = pt::to_f32(wr[i].v[v]);
#pragma unroll
        for (int r = 0; r < kSkinnyRows; ++r)
          acc[r][v] = fmaf(xv[r][i], wf, acc[r][v]);
      }
  }

  // the 4 K lanes of a warp (lane bits 3 and 4), then the 8 warps in order
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[r][v] += __shfl_xor_sync(0xffffffffu, acc[r][v], 8);
      acc[r][v] += __shfl_xor_sync(0xffffffffu, acc[r][v], 16);
    }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kLanesN) {
#pragma unroll
    for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) red[warp][r][lane * V + v] = acc[r][v];
  }
  __syncthreads();
  for (int i = tid; i < kSkinnyRows * BN; i += kThreads) {
    const int r = i / BN, col = i % BN, n = blockIdx.y * BN + col;
    if (r < rows && n < N) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q][r][col];
      y[static_cast<size_t>(r0 + r) * N + n] = pt::from_f32<T>(s);
    }
  }
}

// V elements of a row from k0: one 16-byte load when `vec` (rows and
// pointer 16-byte aligned, K a multiple of V), else element by element,
// zero past K or for an invalid row
template <typename T, int V>
__device__ __forceinline__ void load_k(float (&out)[V],
                                       const T* __restrict__ row, int k0,
                                       int K, bool valid, bool vec) {
  if (valid && vec) {
    pt::Pack<T, V> p;
    ldg16<T, V>(p, row + k0);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = pt::to_f32(p.v[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      out[v] = (valid && k0 + v < K) ? pt::to_f32(row[k0 + v]) : 0.f;
  }
}

// the skinny path over a transposed weight (trans_w): w[e] is (N, K)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_skinny_t_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ offsets, T* __restrict__ y,
                        int K, int N, int E, bool vec_ok) {
  constexpr int V = 16 / sizeof(T);      // K elements a lane loads at once
  constexpr int BN = kThreads / 32 * kColsWarp;
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ Pair s_pair;
  if (!find_pair(offsets, E, kSkinnyRows, blockIdx.x, s_off, &s_pair))
    return;
  const int r0 = s_pair.r0, rows = s_pair.r1 - s_pair.r0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockIdx.y * BN + warp * kColsWarp;
  const T* __restrict__ we = w + static_cast<size_t>(s_pair.e) * K * N;

  float acc[kSkinnyRows][kColsWarp];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsWarp; ++j) acc[r][j] = 0.f;

  for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
    float xv[kSkinnyRows][V];
#pragma unroll
    for (int r = 0; r < kSkinnyRows; ++r)
      load_k<T, V>(xv[r], x + static_cast<size_t>(r0 + r) * K, k0, K,
                   r < rows, vec_ok);
#pragma unroll
    for (int j = 0; j < kColsWarp; ++j) {
      float wv[V];
      load_k<T, V>(wv, we + static_cast<size_t>(nw + j) * K, k0, K,
                   nw + j < N, vec_ok);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int r = 0; r < kSkinnyRows; ++r)
          acc[r][j] = fmaf(xv[r][v], wv[v], acc[r][j]);
    }
  }
  // the 32 lanes' sums by a fixed shuffle tree; lane r * 8 + j stores
  // row r, column j
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsWarp; ++j) {
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], d);
      if (lane == r * kColsWarp + j && r < rows && nw + j < N)
        y[static_cast<size_t>(r0 + r) * N + nw + j] =
            pt::from_f32<T>(acc[r][j]);
    }
}

template <typename T, bool kTransW>
__global__ void __launch_bounds__(kThreads)
    moe_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ offsets, T* __restrict__ y,
                     int K, int N, int E) {
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ Pair s_pair;
  __shared__ float xs[kTileK][kTileM + 4];   // x tile, K-major
  __shared__ float ws[kTileK][kTileN + 4];
  if (!find_pair(offsets, E, kTileM, blockIdx.x, s_off, &s_pair)) return;
  const int r0 = s_pair.r0, rows = s_pair.r1 - s_pair.r0;
  const T* __restrict__ we = w + static_cast<size_t>(s_pair.e) * K * N;
  const int nb = blockIdx.y * kTileN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // loads: x row tid / 4, K columns (tid % 4) * 4 ..; w K row tid / 16,
  // columns (tid % 16) * 4 .. (trans_w: w[e] (N, K) row tid / 4, K
  // columns (tid % 4) * 4 .., as x)
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;
  float xr[4], wr[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + lk + i;
      xr[i] = (lr < rows && k < K)
                  ? pt::to_f32(x[static_cast<size_t>(r0 + lr) * K + k])
                  : 0.f;
    }
    if constexpr (kTransW) {
      const int n = nb + lr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + lk + i;
        wr[i] = (n < N && k < K)
                    ? pt::to_f32(we[static_cast<size_t>(n) * K + k])
                    : 0.f;
      }
    } else {
      const int k = k0 + wk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nb + wn + i;
        wr[i] = (k < K && n < N)
                    ? pt::to_f32(we[static_cast<size_t>(k) * N + n])
                    : 0.f;
      }
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xs[lk + i][lr] = xr[i];
      if constexpr (kTransW)
        ws[lk + i][lr] = wr[i];
      else
        ws[wk][wn + i] = wr[i];
    }
    __syncthreads();
    if (k0 + kTileK < K) load(k0 + kTileK);
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + tx + 16 * j;
      if (r < rows && n < N)
        y[static_cast<size_t>(r0 + r) * N + n] = pt::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* offsets, void* y,
                   int R, int K, int N, int E, bool skinny, bool vec_ok,
                   bool trans_w, cudaStream_t stream) {
  const int bm = skinny ? kSkinnyRows : kTileM;
  const int bn = !skinny ? kTileN
                 : trans_w ? kThreads / 32 * kColsWarp
                           : kLanesN * static_cast<int>(16 / sizeof(T));
  const dim3 grid((R + bm - 1) / bm + min(E, R), (N + bn - 1) / bn);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int* op = static_cast<const int*>(offsets);
  T* yp = static_cast<T*>(y);
  if (skinny && trans_w) {
    moe_skinny_t_kernel<T><<<grid, kThreads, 0, stream>>>(xp, wp, op, yp, K,
                                                          N, E, vec_ok);
  } else if (skinny) {
    moe_skinny_kernel<T><<<grid, kThreads, 0, stream>>>(xp, wp, op, yp, K, N,
                                                        E, vec_ok);
  } else if (trans_w) {
    moe_tiled_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, wp, op, yp,
                                                             K, N, E);
  } else {
    moe_tiled_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, wp, op, yp,
                                                              K, N, E);
  }
  return cudaGetLastError();
}

}  // namespace

// x (R, K), w (E, K, N) or, with trans_w, (E, N, K) (y = x w[e]^T),
// offsets (E + 1) int32, y (R, N); dtype a pt::DType of x and w; skinny 1
// for the weight-streaming path, 0 for the tiled one; vec_ok 1 when the
// skinny path may load 16 bytes at once: w's rows 16-byte aligned (N a
// multiple of 16 / element size and w aligned), with trans_w x's and w's
// rows (K a multiple of 16 / element size, x and w aligned). R = 0
// launches nothing.
extern "C" int pt_moe_grouped_matmul(int device, const void* x, const void* w,
                                     const void* offsets, void* y, int R,
                                     int K, int N, int E, int skinny,
                                     int vec_ok, int trans_w, int dtype,
                                     void* stream) {
  cudaError_t err = pt::set_device(device);
  if (err != cudaSuccess) return err;
  if (R == 0 || N == 0) return cudaSuccess;
  if (E < 1 || E > kMaxExperts || K < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBF16)
    return launch<__nv_bfloat16>(x, w, offsets, y, R, K, N, E, skinny != 0,
                                 vec_ok != 0, trans_w != 0, s);
  if (dtype == pt::kF32)
    return launch<float>(x, w, offsets, y, R, K, N, E, skinny != 0,
                         vec_ok != 0, trans_w != 0, s);
  return cudaErrorInvalidValue;
}
