"""Build and bind the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), all
files at once in parallel, and linked into ONE shared library with a
plain C interface, which is loaded with `ctypes`. The library lands in
a directory of `build/` (beside the package, ignored by git) named by a
hash of the sources and flags: a changed source always rebuilds, and an
unchanged tree reuses the library. The build runs at first use, so the
first kernel call of a process (or `python3 chip_smoke.py`) builds
everything.

The kernels launch on PyTorch's current stream; every C entry returns
`cudaGetLastError()` and `check` raises on a non-zero code. Nothing here
falls back to a plain version: a kernel that cannot be built or
launched is an error.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, 'csrc')
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), 'build')
LIB_NAME = 'libpaddle_tpu_torch_kernels.so'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']

# launches per kernel: each wrapper adds one where it launches its kernel
# (the flash backward launches twice per call: dq, then dk and dv). A
# mode of a TPU kernel that is a kernel of its own in PERF.md's table
# counts under its own key: K5s / K6s (flash_attention_fwd_seg /
# _bwd_seg), K5w / K6w (flash_attention_fwd_window / _bwd_window), K8q
# (paged_decode_attention_int8), K9 (decode_attention_headmajor), K10f8
# (quant_matmul_fp8). X1 (moe_grouped_matmul) replaces XLA's ragged_dot,
# not a Pallas kernel; its backward counts dx (moe_grouped_matmul_dx) and
# dW (moe_grouped_matmul_dw) apart.
LAUNCHES = {'rms_norm': 0, 'rms_norm_bwd': 0, 'softmax_xent_fwd': 0,
            'softmax_xent_bwd': 0, 'flash_attention_fwd': 0,
            'flash_attention_fwd_seg': 0, 'flash_attention_fwd_window': 0,
            'flash_attention_bwd': 0, 'flash_attention_bwd_seg': 0,
            'flash_attention_bwd_window': 0,
            'paged_decode_attention': 0, 'paged_decode_attention_int8': 0,
            'decode_attention': 0, 'decode_attention_headmajor': 0,
            'quant_matmul': 0, 'quant_matmul_int4': 0,
            'quant_matmul_fp8': 0, 'moe_grouped_matmul': 0,
            'moe_grouped_matmul_dx': 0, 'moe_grouped_matmul_dw': 0}

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    'pt_rms_norm_fwd': [_I, _VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _VP],
    'pt_rms_norm_bwd': [_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    'pt_softmax_xent_fwd': [_I, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    'pt_softmax_xent_bwd': [_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    'pt_flash_attention_fwd': [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                               _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _VP],
    'pt_flash_attention_bwd': [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                               _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _I, _VP],
    'pt_flash_attention_tc_fwd': [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _VP, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                  _I, _VP],
    'pt_flash_attention_tc_bwd': [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                  _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                  _I, _VP],
    'pt_paged_decode_attention': [_I] + [_VP] * 11 + [_I] * 9 + [
        _F, _I, _I, _VP],
    'pt_paged_decode_attention_plan': [_I, _I, _I, _I, _I, _I, _VP],
    'pt_capture_begin': [_VP],
    'pt_capture_kernels': [_VP, _VP],
    'pt_decode_attention': [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                            _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _LL,
                            _LL, _LL, _I, _I, _F, _I, _I, _VP],
    'pt_decode_attention_plan': [_I, _I, _I, _I, _I, _I, _VP],
    'pt_quant_matmul': [_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                        _I, _I, _VP],
    'pt_quant_matmul_tc': [_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                           _I, _I, _VP],
    'pt_moe_grouped_matmul': [_I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                              _I, _I, _VP],
    'pt_moe_grouped_matmul_tc': [_I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                 _I, _VP],
    'pt_moe_grouped_matmul_dw': [_I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                 _I, _VP],
}

_lib = None


def _sources():
    return (sorted(glob.glob(os.path.join(CSRC, '*.cu'))),
            sorted(glob.glob(os.path.join(CSRC, '*.cuh'))))


def build_dir():
    """`build/kernels-<hash of sources and flags>`."""
    cu, cuh = _sources()
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, f'kernels-{h.hexdigest()[:16]}')


def _nvcc():
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '',
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME or put nvcc on PATH): the port\'s '
        'kernels are built from paddle_tpu_torch/csrc at first use')


def build():
    """Compile every source (in parallel, `-Xptxas -v`) and link the
    library into `build_dir()`. Returns the library's path. The log
    (each source's compile time and ptxas register and shared-memory
    report) is kept as `build.log`."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    cu, _ = _sources()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='kernels-tmp-', dir=BUILD_ROOT)
    try:
        procs, texts, secs = [], {}, {}
        t0 = time.perf_counter()

        def wait(src, p):   # one thread per compile: its own end time
            try:
                texts[src] = p.communicate(timeout=900)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                texts[src] = p.communicate()[0] + '\nnvcc: killed at 900 s'
            secs[src] = time.perf_counter() - t0

        for src in cu:
            obj = os.path.join(tmp, os.path.basename(src) + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-c', src, '-o', obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        waits = [threading.Thread(target=wait, args=(src, p))
                 for src, _obj, p in procs]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        log, failed = [], []
        for src, _obj, p in procs:
            log.append(f'== nvcc {os.path.basename(src)} '
                       f'({secs[src]:.1f} s) ==\n{texts[src]}')
            if p.returncode:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(log))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, '-shared', '-o', tmp_lib,
             *[obj for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300)
        if link.returncode:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
        with open(os.path.join(tmp, 'build.log'), 'w') as f:
            f.write('\n'.join(log))
        os.makedirs(out_dir, exist_ok=True)
        os.replace(os.path.join(tmp, 'build.log'),
                   os.path.join(out_dir, 'build.log'))
        os.replace(tmp_lib, lib_path)   # atomic: readers see all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build_log():
    path = os.path.join(build_dir(), 'build.log')
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def load():
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [ctypes.c_int]
        lib.pt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err, kernel):
    """Raise when a C entry returned a CUDA error code."""
    if err:
        msg = _lib.pt_error_string(err).decode()
        raise RuntimeError(f'{kernel}: CUDA error {err} ({msg})')


def stream_ptr(t):
    """PyTorch's current stream on `t`'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_card(x, kernel):
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if x.device.type == 'cuda':
        return True
    if x.device.type == 'cpu':
        return False
    raise ValueError(f'{kernel}: no kernel for device {x.device}')


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """The SMs of CUDA device `index` (the kernels' grids are sized by
    them)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def require_cuda(x, kernel):
    """A kernel wrapper's first check: its tensors lie on the card."""
    if x.device.type != 'cuda':
        raise ValueError(f'{kernel} kernel: tensors must be on a CUDA '
                         f'device, got {x.device}')


def kernels_per_call(fn, device):
    """The CUDA kernels one call of `fn` enqueues on `device`: fn runs
    once on a fresh stream (so that its allocations and per-stream
    buffers exist), then once more while that stream is captured into a
    CUDA graph, whose kernel nodes are counted. A check for
    `chip_smoke.py` and the card tests (no path of the port calls it);
    unlike a profiler trace, it cannot come back empty."""
    lib = load()
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        check(lib.pt_capture_begin(stream.cuda_stream), 'capture')
        n = ctypes.c_int(0)
        try:
            fn()
        finally:
            err = lib.pt_capture_kernels(stream.cuda_stream, ctypes.byref(n))
        check(err, 'capture')
    return n.value


def dtype_code(t, kernel):
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f'{kernel}: unsupported dtype {t.dtype}')
    return code
