"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled for
sm_90a at first use into `<repo>/build/kernels/` (listed in .gitignore),
under a name that carries a hash of the source and flags, so an edited
source is rebuilt. No `--use_fast_math`: the aggregator takes sin/cos of
arguments up to 2^(freqs-1) times the input, where the fast intrinsics
lose accuracy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    "fused_knn": {
        # rows, delta, slot_ok, r2, M, C, K, out, stream
        "fused_knn_select": [_P, _P, _P, _F, _I, _I, _I, _P, _P],
    },
    "fused_agg": {
        # feat, d, w, W, b, n_layers, wa, ba, M, K, F, nf, Dd, df, C, bf16,
        # out, stream
        "fused_block1_alpha": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P],
    },
    "fused_agg_bwd": {
        # feat, d, w, g, W, WT, b, n_layers, wa, ba, M, K, F, nf, Dd, df, C,
        # bf16, n_blocks, partial, dfeat, dd, dw, dparams, stream
        "fused_block1_alpha_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                   _P, _P, _P, _P, _P],
    },
}

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return path


def _library_path(name: str):
    """(source, library) of csrc/<name>.cu; the library name carries a hash
    of the source and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{digest.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu unless a build of this exact source
    exists. Returns (library path, process or None)."""
    src, so = _library_path(name)
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    return so, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, so: str, proc) -> str:
    """Wait for a build started by _start_build; nvcc's resource report
    (-Xptxas -v) goes to build/kernels/<lib>.log."""
    if proc is None:
        return so
    out, _ = proc.communicate()
    with open(so[:-3] + ".log", "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(f"{so}.{os.getpid()}.tmp", so)   # atomic: never a stub
    return so


def build(name: str) -> str:
    """Compile csrc/<name>.cu (once per source); returns the library."""
    return _finish_build(name, *_start_build(name))


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        lib.sgnerf_error_string.argtypes = [ctypes.c_int]
        lib.sgnerf_error_string.restype = ctypes.c_char_p
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def build_all() -> float:
    """Build every kernel library, one nvcc per source, all started
    together, then load them; returns the seconds it took."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in _SIGNATURES}
    for name, (so, proc) in started.items():
        _finish_build(name, so, proc)
    for name in _SIGNATURES:
        load(name)
    return time.perf_counter() - t0


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.sgnerf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
