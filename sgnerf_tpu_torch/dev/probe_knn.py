"""K1 and K6 of two sources of `csrc/fused_knn.cu` on the same inputs, in
one run on the card.

Makes seeded inputs at the eval chunk's shapes (221,184 shading points,
C = 64 candidates, K = 8; K6 on tiles of T = 1536 points holding up to
U = 160 distinct rows): a table of cache rows (bf16 offsets, ~60% of the
candidates empty), each point's slot drawn from a window of slots that
moves with its tile (so every tile has more distinct slots than U, as at
the eval chunk), 10% of the points without a slot, K1's rows gathered by
slot and K6's by `tile_unique`. Builds `--other DIR`'s `fused_knn.cu` (a
`csrc` directory, e.g. an earlier commit's, unpacked by `git archive`)
with this package's nvcc flags beside this package's kernel, and prints
one JSON object a source: K1's and K6's device milliseconds
(`_cuda.device_ms`, rounds taken in the order other, this, this, other),
whether the ids equal the plain versions', the registers and spills ptxas
reports for each kernel, and the SHFL and VOTE instructions in each
kernel's SASS.

    python -m sgnerf_tpu_torch.dev.probe_knn [--other DIR] [--seed N]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess

import torch

from ..ops import _cuda
from ..ops.fused_knn import (fused_knn_select_plain,
                             fused_knn_select_tiled_plain, tile_unique)

NT, T, U, C, K = 144, 1536, 160, 64, 8     # the eval chunk: M = NT * T
WINDOW = 300                               # distinct slots a tile draws
R2 = 1.0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_other(csrc: str) -> tuple:
    """(library, ptxas report, source) of DIR/fused_knn.cu built as _cuda
    builds."""
    src = os.path.join(csrc, "fused_knn.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib, log = _cuda.build_at(src, os.path.join(
        os.path.dirname(_cuda.BUILD_DIR), "probe_knn", digest))
    return lib, log, src


def ptxas_report(text: str) -> dict:
    """{kernel: {"registers": N, "spill_bytes": (stores, loads)}} from
    nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.setdefault(fn, {})["spill_bytes"] = (int(m.group(1)),
                                                     int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def make_inputs(seed: int, device) -> tuple:
    """((rows, delta, ok), (rows6, inv, delta, ok)): K1's and K6's inputs
    at the eval chunk's shapes (see the module docstring)."""
    g = torch.Generator(device=device).manual_seed(seed)
    M = NT * T
    n_slots = NT * WINDOW // 2 + WINDOW
    off = (torch.randn(n_slots, 3, C, generator=g, device=device)
           .to(torch.bfloat16).view(torch.int16))
    pid = torch.randint(0, 2 ** 31 - 1, (n_slots, C), generator=g,
                        device=device, dtype=torch.int32)
    pid = torch.where(torch.rand(n_slots, C, generator=g, device=device)
                      < 0.6, torch.full_like(pid, -1), pid)
    table = torch.cat([off.reshape(n_slots, 3 * C),
                       (pid & 0xFFFF).to(torch.int16),
                       (pid >> 16).to(torch.int16)], dim=1)
    tile = torch.arange(M, device=device) // T
    slot = (tile * (WINDOW // 2) + torch.randint(
        0, WINDOW, (M,), generator=g, device=device)).to(torch.int32)
    ok = torch.rand(M, generator=g, device=device) >= 0.1
    delta = torch.randn(M, 3, generator=g, device=device) * 0.5
    uniq, inv = tile_unique(slot, ok, T, U)
    rows6 = table[uniq.reshape(-1).clamp(min=0).long()]
    return (table[slot.long()], delta, ok), (rows6, inv, delta, ok)


def launchers(lib, k1, k6):
    """Closures that launch K1 and K6 of `lib` into their outputs."""
    p = _cuda.ptr
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows, delta, ok = k1
    M = rows.shape[0]
    out1 = torch.empty((M, K), dtype=torch.int32, device=rows.device)
    rows6, inv, delta6, ok6 = k6
    out6 = torch.empty((M, K), dtype=torch.int32, device=rows.device)

    def run1():
        err = lib.fused_knn_select(p(rows), p(delta), p(ok.view(torch.uint8)),
                                   R2, M, C, K, p(out1), stream)
        assert err == 0, err
        return out1

    def run6():
        err = lib.fused_knn_select_tiled(
            p(rows6), p(inv), p(delta6), p(ok6.view(torch.uint8)), R2,
            M // T, T, U, C, K, p(out6), stream)
        assert err == 0, err
        return out6
    return run1, run6


def load(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    lib.fused_knn_select.argtypes = [_P, _P, _P, _F, _I, _I, _I, _P, _P]
    lib.fused_knn_select_tiled.argtypes = [_P, _P, _P, _P, _F, _I, _I, _I,
                                           _I, _I, _P, _P]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    k1, k6 = make_inputs(a.seed, torch.device("cuda"))
    ref1 = fused_knn_select_plain(*k1, R2, C=C, K=K)
    ref6 = fused_knn_select_tiled_plain(*k6, R2, C=C, K=K, T=T, U=U)
    this_lib = _cuda.build("fused_knn")
    with open(this_lib[:-3] + ".log") as f:
        this_log = f.read()
    sources = {"this": (this_lib, this_log, os.path.join(_cuda.CSRC,
                                                         "fused_knn.cu"))}
    if a.other:
        sources["other"] = build_other(a.other)
    runs, results = {}, {}
    for name, (lib_path, log_text, src) in sources.items():
        runs[name] = launchers(load(lib_path), k1, k6)
        r1, r6 = runs[name]
        counts = (_cuda.sass_counts(lib_path, ("SHFL", "VOTE"))
                  if _cuda.cuobjdump() else "cuobjdump not found")
        results[name] = {
            "source": src, "k1_equal": bool(torch.equal(r1(), ref1)),
            "k6_equal": bool(torch.equal(r6(), ref6)),
            "ptxas": ptxas_report(log_text), "sass": counts,
            "k1_ms": [], "k6_ms": []}
    for name in (["other", "this", "this", "other"] if a.other else ["this"]):
        r1, r6 = runs[name]
        results[name]["k1_ms"].append(_cuda.device_ms(r1))
        results[name]["k6_ms"].append(_cuda.device_ms(r6))
    smi = shutil.which("nvidia-smi")
    card = (subprocess.run([smi, "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip() if smi else "unknown")
    found = float((ref1 >= 0).sum(dim=1).float().mean())
    held = int((k6[1] < U).sum())
    for name, res in results.items():
        print(json.dumps({"card": card, "label": name, "seed": a.seed,
                          "M": NT * T, "k1_ids_found_a_point": found,
                          "k6_points_holding_a_row": held, **res}))


if __name__ == "__main__":
    main()
