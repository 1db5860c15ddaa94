"""Build the CUDA kernels in `nnop_tpu_torch/csrc/` and load them with ctypes.

The sources have a plain C interface (no PyTorch headers), so they build
in seconds; `torch.utils.cpp_extension` would take minutes. Each `.cu`
compiles to an object in its own `nvcc` process, all started together,
and one more links them. The library goes into
`build/nnop_tpu_torch/<hash>/` at the root of the checkout, keyed by a
hash of the sources and flags, and is built at first use. Each C entry point returns `cudaGetLastError()` after its
launch; the op wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "nnop_tpu_torch")
LIB_NAME = "libnnop_tpu_torch.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types (pointers and the stream are
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    # q, k, v, kpad, pair, q_seg, kv_seg, o, lse, B, QH, KH, QL, KL, E,
    # pair_f32, scale, causal, offset, window, softcap, stream
    "nnop_flash_fwd": [_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _F, _P],
    # q, k, v, o, dout, lse, kpad, pair, q_seg, kv_seg, dq, dpair, delta, B,
    # QH, KH, QL, KL, E, pair_f32, scale, causal, window, softcap, stream
    "nnop_flash_bwd_dq": [_P] * 13 + [_I] * 7 + [_F, _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, kpad, pair, q_seg, kv_seg, dk, dv, B, QH,
    # KH, QL, KL, E, pair_f32, scale, causal, window, softcap, stream
    "nnop_flash_bwd_dkv": [_P] * 12 + [_I] * 7 + [_F, _I, _I, _F, _P],
    # q, k_cache, v_cache, k_scale, v_scale, k_stage, v_stage, lengths,
    # page_table, o, ws, tickets, ws_elems, n_tickets, B, QH, KH, S, E, T,
    # n_blocks, max_pages, n_layers, layer, W, staged_n, scale, window,
    # softcap, q_is_f32, cache_is_int8, n_split, stream
    "nnop_decode_attention": [_P] * 12 + [_L] + [_I] * 13 + [_F, _I, _F, _I, _I, _I, _P],
    # k_stage, v_stage, k_cache, v_cache, k_scale, v_scale, lengths,
    # page_table, B, n_blocks, max_pages, n_layers, KH, S, W, E, cache_kind,
    # stream
    "nnop_flush_staging": [_P] * 8 + [_I] * 9 + [_P],
    # cache, new, positions, B, KH, S, D, elem_bytes, stream
    "nnop_write_kv_token": [_P] * 3 + [_I] * 5 + [_P],
    # x, w, scale, out, partial, M, N, K, mode, group, pack_block, splits, stream
    "nnop_qmm": [_P] * 5 + [_I] * 7 + [_P],
    # xv, xs, w, ws, out, M, N, K, out_is_f32, stream
    "nnop_qmm_w8a8": [_P] * 5 + [_I] * 4 + [_P],
    # x, xs, w, scale, out, block_groups, block_rows, M, N, K, block_m, mode,
    # group, pack_block, out_is_f32, stream
    "nnop_gmm": [_P] * 7 + [_I] * 8 + [_P],
    # x, dy, dw, block_groups, block_rows, M, K, N, E, block_m, stream
    "nnop_gmm_dw": [_P] * 5 + [_I] * 5 + [_P],
}


@dataclasses.dataclass
class BuildResult:
    path: str
    seconds: float  # time spent in nvcc (0 when the library was cached)
    log: str  # nvcc's output (ptxas register and shared-memory report)


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def build() -> BuildResult:
    """Compile csrc/*.cu into one shared library unless a build of the
    same sources and flags exists. Raises with nvcc's stderr on failure."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(path):
        return BuildResult(path, 0.0, "")
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return BuildResult(path, time.perf_counter() - t0, "".join(log))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(build().path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nnop_error_string.argtypes = [ctypes.c_int]
    lib.nnop_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, err: int):
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load_library().nnop_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({msg})")
