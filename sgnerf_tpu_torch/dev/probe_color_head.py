"""The colour head's kernel (K4's and K5's second launch,
`csrc/fused_agg_color.cu`) of two or more sources on the same inputs, in
one run on the card.

Makes seeded inputs at the eval chunk's shapes (221,184 shading points;
K2's reduced rows of C = 256 features and an alpha, unit view
directions, the canonical colour head: vf = 4, 4 layers, 128 hidden;
K5's rays of SR = 24 points). Builds each `--other DIR`'s
`fused_agg_color.cu` (a `csrc` directory, e.g. an earlier commit's,
unpacked by `git archive`) with this package's nvcc flags beside this
package's kernel, and prints one JSON object a source and mode: the
device milliseconds of K4's and K5's colour launch (`_cuda.device_ms`,
rounds taken in the order others, this, this, others reversed), the
largest difference of its outputs from this package's kernel's, and the
registers and spills ptxas reports.

    python -m sgnerf_tpu_torch.dev.probe_color_head [--other DIR ...]
        [--seed N]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os

import torch

from ..ops import _cuda
from ..ops.fused_agg import fused_color_head
from .probe_knn import ptxas_report

M, C, VF, NH, LAYERS, SR = 221_184, 256, 4, 128, 4, 24


def build(csrc: str, flags=()) -> tuple:
    """(ctypes library, ptxas report) of DIR/fused_agg_color.cu built as
    _cuda builds (with `flags` added), its entry points typed as _cuda
    types them."""
    src = os.path.join(csrc, "fused_agg_color.cu")
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in (src, os.path.join(csrc, "fused_agg_body.cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    so, log = _cuda.build_at(src, os.path.join(
        os.path.dirname(_cuda.BUILD_DIR), "probe_color_head",
        digest.hexdigest()[:12]), flags)
    return (_cuda.open_library(so, "fused_agg_color"),
            ptxas_report(log))


def inputs(seed: int, dev):
    g = torch.Generator().manual_seed(seed)
    red = torch.cat([torch.randn(M, C, generator=g) * 0.5,
                     torch.rand(M, 1, generator=g) * 3], -1)
    vd = torch.randn(M, 3, generator=g)
    vd = vd / vd.norm(dim=-1, keepdim=True)
    sizes = [C + 6 * VF] + [NH] * (LAYERS - 1) + [3]
    color = [{"w": (torch.randn(i, o, generator=g) * (2.0 / (i + o)) ** 0.5
                    ).to(dev),
              "b": (torch.randn(o, generator=g) * 0.05).to(dev)}
             for i, o in zip(sizes[:-1], sizes[1:])]
    march = ((torch.rand(M, generator=g) * 0.5 + 0.02).to(dev),
             (torch.rand(M, generator=g) < 0.8).float().to(dev), SR)
    return red.to(dev), vd.to(dev), color, march


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    red, vd, color, march = inputs(args.seed, dev)
    this = _cuda.load("fused_agg_color")
    this_so = _cuda.build("fused_agg_color")
    with open(this_so[:-3] + ".log") as f:
        this_regs = ptxas_report(f.read())
    libs = {"this": (this, this_regs)}
    for d in args.other:
        libs[d] = build(d)
    order = list(args.other) + ["this", "this"] + list(reversed(args.other))
    for bf16 in (True, False):
        ref, times, outs = {}, {k: {"k4": [], "k5": []} for k in libs}, {}
        for name in order:
            with _cuda.using("fused_agg_color", libs[name][0]), \
                    torch.inference_mode():
                k4 = fused_color_head(red, vd, color, vf=VF, bf16=bf16)
                k5 = fused_color_head(red, vd, color, vf=VF, bf16=bf16,
                                      march=march)
                outs[name] = (k4, k5)
                times[name]["k4"].append(_cuda.device_ms(
                    lambda: fused_color_head(red, vd, color, vf=VF,
                                             bf16=bf16), reps=20))
                times[name]["k5"].append(_cuda.device_ms(
                    lambda: fused_color_head(red, vd, color, vf=VF,
                                             bf16=bf16, march=march),
                    reps=20))
        ref = outs["this"]
        for name in libs:
            k4, k5 = outs[name]
            print(json.dumps({
                "source": name, "bf16": bf16,
                "k4_ms": times[name]["k4"], "k5_ms": times[name]["k5"],
                "k4_max_diff": float((k4 - ref[0]).abs().max()),
                "k5_max_diff": float((k5 - ref[1]).abs().max()),
                "ptxas": libs[name][1]}), flush=True)


if __name__ == "__main__":
    main()
