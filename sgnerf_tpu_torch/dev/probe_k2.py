"""K2 (`csrc/fused_agg.cu`) of two or more sources on the same inputs, in
one run on the card.

Makes seeded inputs at the eval chunk's shapes (221,184 shading points of
K = 8 slots; features 32, distances 6, PE of 3 and 5 frequencies, block1
284 -> 256 -> 256, a one-layer alpha head) under masks of several fills:
a point holds no neighbour or its first c slots (c uniform in 1..K, as
K1 fills the nearest first), at 10%, 27% and 50% of the slots, and every
slot. Builds each `--other DIR`'s `fused_agg.cu` (a `csrc` directory, e.g.
an earlier commit's, unpacked by `git archive`) with this package's nvcc
flags beside this package's kernel, and prints one JSON object a source,
mode and fill: K2's device milliseconds a call (`_cuda.device_ms`, rounds
taken in the order others, this, this, others reversed), whether its
output equals this package's kernel's bit for bit, and, for this source,
the device milliseconds of the plan's launches alone and the rows its
tiles held.

    python -m sgnerf_tpu_torch.dev.probe_k2 [--other DIR ...] [--seed N]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os

import torch

from ..ops import _cuda
from ..ops.fused_agg import _alpha_args, pack_block1

M, K, F, DD, NF, DF, C, LAYERS = 221_184, 8, 32, 6, 3, 5, 256, 2
FILLS = (0.1, 0.27, 0.5, 1.0)
_P, _I = ctypes.c_void_p, ctypes.c_int
# fused_block1_alpha before the plan: no plan argument
_OLD_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _P]


def build(csrc: str) -> ctypes.CDLL:
    """DIR/fused_agg.cu built as _cuda builds, its K2 entry typed for the
    signature it has."""
    src = os.path.join(csrc, "fused_agg.cu")
    digest = hashlib.sha1()
    for path in (src, os.path.join(csrc, "fused_agg_body.cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    so, _ = _cuda.build_at(src, os.path.join(
        os.path.dirname(_cuda.BUILD_DIR), "probe_k2",
        digest.hexdigest()[:12]))
    lib = ctypes.CDLL(so)
    if hasattr(lib, "fused_block1_alpha_plan_words"):
        return _cuda.open_library(so, "fused_agg")
    lib.fused_block1_alpha.argtypes = _OLD_ARGS
    lib.fused_block1_alpha.restype = _I
    lib.sgnerf_error_string.argtypes = [_I]
    lib.sgnerf_error_string.restype = ctypes.c_char_p
    return lib


def inputs(seed: int, dev):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(M, K, F, generator=g) * 0.2
    d = torch.randn(M, K, DD, generator=g) * 0.05
    w = torch.rand(M, K, generator=g) + 0.01
    in0 = F + 2 * F * NF + 2 * DD * DF
    block1 = [{"w": torch.randn(i, C, generator=g) * (2.0 / (i + C)) ** 0.5,
               "b": torch.randn(C, generator=g) * 0.05}
              for i in [in0] + [C] * (LAYERS - 1)]
    alpha = [{"w": torch.randn(C, 1, generator=g) * 0.1,
              "b": torch.randn(1, generator=g) * 0.1}]
    masks = {}
    for fill in FILLS:
        if fill >= 1.0:
            masks[fill] = torch.ones(M, K, dtype=torch.bool)
            continue
        c = torch.randint(1, K + 1, (M,), generator=g)
        hit = torch.rand(M, generator=g) < fill * K / ((K + 1) / 2)
        masks[fill] = (torch.arange(K)[None] < c[:, None]) & hit[:, None]
    to = (lambda t: t.to(dev))
    return (to(feat), to(d), {f: to(w * m) for f, m in masks.items()},
            [{k: to(v) for k, v in l_.items()} for l_ in block1],
            [{k: to(v) for k, v in l_.items()} for l_ in alpha])


def launcher(lib, feat, d, w, block1, alpha, bf16):
    """fn() that launches the library's K2 into one output (and plan)."""
    Wall, Ball = pack_block1(block1, block1[0]["w"].shape[0], bf16)
    wa, ba = _alpha_args(alpha)
    out = torch.empty(M, C + 1, device=feat.device)
    args = [_cuda.ptr(feat), _cuda.ptr(d), _cuda.ptr(w), _cuda.ptr(Wall),
            _cuda.ptr(Ball), len(block1), _cuda.ptr(wa), _cuda.ptr(ba), M, K,
            F, NF, DD, DF, C, int(bf16)]
    plan = None
    if hasattr(lib, "fused_block1_alpha_plan_words"):
        plan = torch.empty(lib.fused_block1_alpha_plan_words(M, K, int(bf16)),
                           dtype=torch.int32, device=feat.device)
        args.append(_cuda.ptr(plan))
    args += [_cuda.ptr(out), _cuda.stream_of(feat)]

    def fn():
        _cuda.check(lib, lib.fused_block1_alpha(*args), "fused_block1_alpha")
        return out
    return fn, plan, (Wall, Ball, wa, ba)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    feat, d, ws, block1, alpha = inputs(args.seed, dev)
    libs = {"this": _cuda.load("fused_agg")}
    for o in args.other:
        libs[o] = build(o)
    order = list(args.other) + ["this", "this"] + list(reversed(args.other))
    for bf16 in (False, True):
        for fill, w in ws.items():
            times = {k: [] for k in libs}
            outs, extra = {}, {}
            for name in order:
                fn, plan, keep = launcher(libs[name], feat, d, w, block1,
                                          alpha, bf16)
                outs[name] = fn().clone()
                times[name].append(_cuda.device_ms(fn, reps=10))
                if plan is not None and name == "this":
                    lib = libs[name]
                    wp = _cuda.ptr(w)
                    out = torch.empty(M, C + 1, device=dev)
                    extra["plan_ms"] = _cuda.device_ms(
                        lambda: lib.fused_block1_alpha_plan(
                            wp, M, K, C, int(bf16), _cuda.ptr(plan),
                            _cuda.ptr(out), _cuda.stream_of(w)), reps=10)
                    fn()
                    extra["rows_held"] = int(plan[1])
                del keep
            ref = outs["this"].view(torch.int32)
            live = float((w != 0).float().mean())
            for name in libs:
                got = outs[name].view(torch.int32)
                print(json.dumps({
                    "source": name, "bf16": bf16, "fill": live,
                    "ms": times[name],
                    "bits_equal": bool(torch.equal(got, ref)),
                    "words_differ": int((got != ref).sum()),
                    **(extra if name == "this" else {})}), flush=True)


if __name__ == "__main__":
    main()
