"""Where a colour-head tile's time goes on the card: a per-phase clock of
K4's and K5's second launch (`csrc/fused_agg_color.cu`).

Builds the kernel's sources with `-DSGNERF_COLOR_PHASES`, which turns on
the phase marks in the source: clock64() kept by thread 0 of each block
around the tile's fill (`fill`, of which `fill_rows` copies K2's rows into
A and the rest forms the PE) and its layers (`layers`, of which
`ring_wait` waits for a weight slice's TMA copy, `ring_sync` is the block
barrier that hands stages back, `epilogue` the tensor cores' last wait,
the bias, LeakyReLU and the next A), summed over the blocks. It runs the
build on `probe_color_head`'s seeded eval-chunk inputs (221,184 points,
the canonical head; K5 at SR 24).

    python -m sgnerf_tpu_torch.dev.probe_color_phases [--csrc DIR]

Prints one JSON object a mode and kernel: the mean cycles a tile by
phase, as thread 0 of its block sees them (with two blocks an SM, each
block's phases include the time the other takes).
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops import _cuda
from ..ops.fused_agg import head_plan
from . import probe_color_head as pch

FIELDS = ("ring_wait", "ring_sync", "epilogue", "fill", "layers",
          "fill_rows")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=_cuda.CSRC)
    args = ap.parse_args(argv)
    lib, _ = pch.build(args.csrc, ["-DSGNERF_COLOR_PHASES"])
    lib.color_phases_read.argtypes = [ctypes.c_void_p]
    lib.color_phases_read.restype = ctypes.c_int
    red, vd, color, march = pch.inputs(0, torch.device("cuda"))
    buf = (ctypes.c_ulonglong * 8)()
    with _cuda.using("fused_agg_color", lib), torch.inference_mode():
        for bf16 in (True, False):
            rows = head_plan(pch.C, pch.VF, pch.NH, pch.LAYERS, bf16)["rows"]
            for m in (None, march):
                for _ in range(2):   # the first call builds the pack
                    _cuda.check(lib, lib.color_phases_read(buf), "probe")
                    pch.fused_color_head(red, vd, color, vf=pch.VF,
                                         bf16=bf16, march=m)
                    torch.cuda.synchronize()
                _cuda.check(lib, lib.color_phases_read(buf), "probe")
                tiles = (-(-pch.M // rows) if m is None
                         else -(-(pch.M // pch.SR) // (rows // pch.SR)))
                print(json.dumps({"bf16": bf16, "kernel": "K5" if m else "K4",
                                  "tiles": tiles,
                                  **{k: buf[i] / tiles
                                     for i, k in enumerate(FIELDS)}}),
                      flush=True)


if __name__ == "__main__":
    main()
