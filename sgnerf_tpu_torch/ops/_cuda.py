"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (shared device code
lives in `csrc/*.cuh`). It is compiled for sm_90a at first use into
`<repo>/build/kernels/` (listed in .gitignore), under a name that carries
a hash of the source, the headers it includes and the flags, so an edited
source or header is rebuilt. No `--use_fast_math`: the aggregator takes
sin/cos of arguments up to 2^(freqs-1) times the input, where the fast
intrinsics lose accuracy.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import statistics
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    "fused_knn": {
        # rows, delta, slot_ok, r2, M, C, K, out, stream
        "fused_knn_select": [_P, _P, _P, _F, _I, _I, _I, _P, _P],
        # rows, inv, delta, slot_ok, r2, nt, T, U, C, K, out, stream
        "fused_knn_select_tiled": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                                   _P, _P],
        # C, U, *regs[2], *smem_bytes[2], *blocks_per_sm[2] (K1, K6)
        "fused_knn_occupancy": [_I, _I, _P, _P, _P],
    },
    "fused_agg": {
        # feat, d, w, W, b, n_layers, wa, ba, M, K, F, nf, Dd, df, C, bf16,
        # out, stream
        "fused_block1_alpha": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P],
        # F, nf, Dd, df, C, bf16, *regs, *smem_bytes, *blocks_per_sm
        "fused_block1_alpha_occupancy": [_I, _I, _I, _I, _I, _I, _P, _P,
                                         _P],
        # F, nf, Dd, df, C, bf16 -> shared memory bytes a block, 0: too big
        "fused_block1_alpha_smem": [_I, _I, _I, _I, _I, _I],
    },
    "fused_agg_color": {
        # red, vd, W, b, n_layers, Nh, M, C, vf, ray_dist, ray_valid, SR
        # (0: K4), bf16, out, hid (null: none), stream
        "fused_color_head": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                             _I, _P, _P, _P],
        # K, F, nf, Dd, df, C, vf, n_clayers, Nh, SR (0: K4), bf16 ->
        # shared memory bytes of the head's block, 0: K2's or its too big
        "fused_block1_alpha_color_smem": [_I, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I],
        # C, vf, n_layers, Nh, bf16 -> shared memory bytes, 0: too big
        "fused_color_head_smem": [_I, _I, _I, _I, _I],
        # C, vf, n_layers, Nh, bf16, *regs, *smem_bytes, *blocks_per_sm
        "fused_color_head_occupancy": [_I, _I, _I, _I, _I, _P, _P, _P],
    },
    "fused_agg_bwd": {
        # feat, d, W, b, n_layers, wa, ba, N, F, nf, Dd, df, C, bf16, x,
        # ldx, h, raw, stream
        "fused_agg_bwd_recompute": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _P, _I, _P, _P, _P],
        # x, ldx, h, raw, w, g, WT, wa, n_layers, N, K, F, nf, Dd, df, C,
        # bf16, dfeat, dd, dw, dh, alpha_part, stream
        "fused_agg_bwd_dgrad": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                _P],
        # x, ldx, h, dh, alpha_part, n_tiles, n_layers, N, in0, C, bf16,
        # partial, out, stream
        "fused_agg_bwd_wgrad": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P],
        # F, nf, Dd, df, C, bf16, *regs[3], *smem_bytes[3], *blocks[3]
        "fused_agg_bwd_occupancy": [_I, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "gather_rows": {
        # table, idx, out, S, row_bytes, T, wave, stream
        "gather_rows": [_P, _P, _P, _L, _I, _I, _I, _P],
        "gather_rows_staged": [_P, _P, _P, _L, _I, _I, _I, _P],
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


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: str) -> list:
    """src and every csrc header it includes ("..."), transitively."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            todo += [os.path.join(CSRC, h.decode())
                     for h in _INCLUDE.findall(f.read())]
    return seen


def _library_path(name: str):
    """(source, library) of csrc/<name>.cu; the library name carries a hash
    of the source, the headers it includes and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        with open(path, "rb") as f:
            digest.update(f.read())
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
        lib = _libs[name] = open_library(build(name), name)
    return lib


def open_library(so: str, name: str) -> ctypes.CDLL:
    """A built library of csrc/<name>.cu's C interface, its entry points
    typed."""
    lib = ctypes.CDLL(so)
    lib.sgnerf_error_string.argtypes = [ctypes.c_int]
    lib.sgnerf_error_string.restype = ctypes.c_char_p
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_at(src: str, out_dir: str, flags=()) -> tuple:
    """Compile a source outside the kernels' build (a probe's: an earlier
    commit's kernel, or one built with extra defines in `flags`) as
    `build` compiles the kernels, into out_dir -> (library path, nvcc's
    output, which holds ptxas's resource report)."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(out_dir, f"lib{stem}.so")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    return so, res.stdout + res.stderr


@contextlib.contextmanager
def using(name: str, lib: ctypes.CDLL):
    """The wrappers of csrc/<name>.cu call `lib` (a probe's build of
    another source) inside the block, this package's library after it."""
    this = load(name)
    _libs[name] = lib
    try:
        yield
    finally:
        _libs[name] = this


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


def cuobjdump() -> str:
    """The toolkit's cuobjdump (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin),
    or None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    return path if os.path.exists(path) else None


def sass_counts(lib: str, ops) -> dict:
    """{kernel (mangled name): {op: instructions}} of a built library's
    SASS (`cuobjdump -sass`): the static count of each opcode in `ops`
    (e.g. "SHFL" counts SHFL.BFLY and SHFL.IDX). Needs the toolkit."""
    dump = cuobjdump()
    if dump is None:
        raise RuntimeError("cuobjdump not found: cannot read the SASS")
    sass = subprocess.run([dump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            out[fn] = dict.fromkeys(ops, 0)
        elif fn is not None and "/*" in line:
            for op in ops:
                if re.search(rf"\b{op}(\.|\s)", line):
                    out[fn][op] += 1
    return out


def device_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over `rounds` of the device milliseconds a call of fn() takes
    when `reps` calls run back to back behind a spin kernel (so the host's
    launch overhead stays off the clock), by CUDA events. Longer than
    reps x a call's device time the spin must last; ~30 ms covers 50 calls
    of the port's sub-millisecond kernels."""
    import torch
    fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)      # ~30 ms: the reps queue behind it
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


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
