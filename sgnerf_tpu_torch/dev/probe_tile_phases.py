"""Where a K2 tile's time goes on the card: a per-phase clock of the body.

Makes an instrumented copy of `csrc/fused_agg_body.cuh` and
`csrc/fused_agg.cu` under `build/probe_tile_phases/<label>/`: clock64()
at the tile body's phase boundaries and around the weight ring's waits,
its barriers and the tensor cores' waits, kept by the first thread of
each warpgroup and written to a buffer a tile. It builds the copy with
nvcc as `ops/_cuda.py` builds the kernels and runs it at an eval chunk's
shape (M = 221,184 points, K = 8, block1 284 -> 256 -> 256, seeded
weights), beside the uninstrumented K2 of the package (CUDA events,
median of REPS). `--other DIR` adds another copy of the kernel sources
(a `csrc` directory, e.g. an earlier commit's, unpacked by `git archive`)
to the same run; the weights are packed by this package's `pack_block1`.

    python -m sgnerf_tpu_torch.dev.probe_tile_phases [--bf16] [--other DIR]

Prints one JSON object a source: K2's ms, the instrumented kernel's ms,
the tiles and their rows, and the mean cycles a tile by phase and by
warpgroup: `pe` (raw rows staged, PE rows written), `products` (every
layer's k-slice loop, of which `ring_wait` waits for a slice's TMA copy,
`ring_sync` is the block barrier that hands a stage back, `mma_wait` the
wait for the previous slice's wgmmas), `epilogue` (bias, LeakyReLU, the
next A), `tail` (alpha and the K-sum) and `total`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics

import torch

from ..ops import _cuda
from ..ops.fused_agg import _alpha_args, fused_block1_alpha, pack_block1

REPS = 20
FIELDS = ("total", "pe", "products", "ring_wait", "ring_sync", "mma_wait",
          "epilogue", "tail")


def _sub(pattern, repl, text, count=1):
    out, n = re.subn(pattern, repl, text, count=count)
    if n != count:
        raise RuntimeError(f"anchor not found: {pattern!r}")
    return out


def instrument(body: str) -> str:
    """The tile body with the probe's clocks (see the module docstring)."""
    body = _sub(r"namespace sgnerf_agg \{\n",
                "namespace sgnerf_agg {\n__device__ long long* g_probe;\n",
                body)
    body = _sub(r"(\n  const int tid = threadIdx\.x;\n)",
                r"\1  long long P[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                r"  const long long P_t0 = clock64();\n", body)
    body = _sub(r"(\n  // ---- 2\. block1 on the tensor cores)",
                r"\n  P[1] = clock64() - P_t0;\1", body)
    body = _sub(r"(\n    const int ns = l == 0 \? s_first : s_rest;\n)",
                r"\1    const long long P_ls = clock64();\n", body)
    body = _sub(r"\n(\s+)(bar_wait\(smem_addr\(bars \+ stage\), "
                r"\(gi / kStages\) & 1\);)",
                r"\n\1const long long P_w = clock64();\n\1\2\n"
                r"\1P[3] += clock64() - P_w;", body)
    body = _sub(r"\n(\s+)(asm volatile\(\"wgmma\.wait_group\.sync\.aligned 1;"
                r"\\n\" ::: \"memory\"\);)",
                r"\n\1const long long P_g = clock64();\n\1\2\n"
                r"\1P[5] += clock64() - P_g;", body)
    body = _sub(r"\n(\s+)(__syncthreads\(\);[^\n]*\n\s+refill\(it\);)",
                r"\n\1const long long P_s = clock64();\n\1\2\n"
                r"\1P[4] += clock64() - P_s;", body)
    body = _sub(r"(\n    wgmma_wait_all\(acc\);\n)",
                r"\1    P[2] += clock64() - P_ls;\n"
                r"    const long long P_es = clock64();\n", body)
    body = _sub(r"(\n    __syncthreads\(\);\n)(  \}\n  ring_it = it0 \+ n_slices;)",
                r"\1    P[6] += clock64() - P_es;\n\2"
                r"\n  const long long P_te = clock64();", body)
    return _sub(r"\n  __syncthreads\(\);\n\}\n\n\}  // namespace sgnerf_agg",
                "\n  __syncthreads();\n"
                "  P[7] = clock64() - P_te;\n"
                "  P[0] = clock64() - P_t0;\n"
                "  if ((tid & 127) == 0) {\n"
                "    long long* o = g_probe + (blockIdx.x * 2 + (tid >> 7)) * 8;\n"
                "    for (int i = 0; i < 8; ++i) o[i] = P[i];\n"
                "  }\n"
                "}\n\n}  // namespace sgnerf_agg", body)


def build_probe(csrc: str, label: str) -> str:
    """The instrumented K2 of the sources in `csrc`, built; its path."""
    out = os.path.join(os.path.dirname(_cuda.BUILD_DIR), "probe_tile_phases",
                       label)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(csrc, "fused_agg_body.cuh")) as f:
        body = instrument(f.read())
    with open(os.path.join(out, "fused_agg_body.cuh"), "w") as f:
        f.write(body)
    with open(os.path.join(csrc, "fused_agg.cu")) as f:
        k2 = f.read()
    k2 += ("\nextern \"C\" int probe_set(void* p) {\n"
           "  return static_cast<int>(cudaMemcpyToSymbol(sgnerf_agg::g_probe,"
           " &p, sizeof(p)));\n}\n")
    src = os.path.join(out, "probe.cu")
    with open(src, "w") as f:
        f.write(k2)
    return _cuda.build_at(src, out)[0]


def _inputs(dev, M=221_184, K=8, F=32, Dd=6, C=256):
    g = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(M, K, F, device=dev, generator=g) * 0.2
    d = torch.randn(M, K, Dd, device=dev, generator=g) * 0.05
    w = torch.rand(M, K, device=dev, generator=g)
    in0 = F + 2 * F * 3 + 2 * Dd * 5
    block1 = [{"w": torch.randn(i, C, device=dev, generator=g)
               * (2.0 / (i + C)) ** 0.5,
               "b": torch.randn(C, device=dev, generator=g) * 0.05}
              for i in (in0, C)]
    alpha = [{"w": torch.randn(C, 1, device=dev, generator=g) * 0.1,
              "b": torch.randn(1, device=dev, generator=g) * 0.1}]
    return feat, d, w, block1, alpha


def _ms(fn):
    ts = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def probe(so: str, label: str, bf16: bool, dev) -> dict:
    feat, d, w, block1, alpha = _inputs(dev)
    M, K, F = feat.shape
    Dd, C = d.shape[-1], block1[0]["w"].shape[1]
    in0 = block1[0]["w"].shape[0]
    Wp, Bias = pack_block1(block1, in0, bf16)
    wa, ba = _alpha_args(alpha)
    with open(os.path.join(os.path.dirname(so), "fused_agg_body.cuh")) as f:
        tiled = "tile_rows(bool bf16)" in f.read()
    rows = 64 if tiled and not bf16 else 128   # f32 mode's 64-row tiles
    tiles = -(-M // (rows // K))
    buf = torch.zeros(tiles * 2 * 8, dtype=torch.int64, device=dev)
    lib = ctypes.CDLL(so)
    lib.probe_set(ctypes.c_void_p(buf.data_ptr()))
    out = torch.empty(M, C + 1, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int

    def run():
        err = lib.fused_block1_alpha(
            P(feat.data_ptr()), P(d.data_ptr()), P(w.data_ptr()),
            P(Wp.data_ptr()), P(Bias.data_ptr()), I(len(block1)),
            P(wa.data_ptr()), P(ba.data_ptr()), I(M), I(K), I(F), I(3),
            I(Dd), I(5), I(C), I(int(bf16)), P(out.data_ptr()),
            P(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"probe launch failed: {err}")
    run()
    torch.cuda.synchronize()
    ref = torch.cat(fused_block1_alpha(feat, d, w, block1, alpha, K=K, nf=3,
                                       df=5, bf16=bf16), -1)
    t_probe = _ms(run)
    t_k2 = _ms(lambda: fused_block1_alpha(feat, d, w, block1, alpha, K=K,
                                          nf=3, df=5, bf16=bf16))
    cyc = buf.view(tiles, 2, 8).double().mean(0)
    return {"source": label, "bf16": bf16, "tile_rows": rows,
            "tiles": tiles, "k2_ms": t_k2, "probe_ms": t_probe,
            "probe_vs_package_max_abs_diff": float((out - ref).abs().max()),
            "cycles_a_tile": {f"wg{g}": dict(zip(FIELDS, cyc[g].tolist()))
                              for g in range(2)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--other", default=None,
                    help="another csrc directory to probe in the same run")
    args = ap.parse_args()
    dev = torch.device("cuda")
    here = _cuda.CSRC
    srcs = [("this tree", here)] + ([("other", args.other)] if args.other
                                     else [])
    for label, csrc in srcs:
        so = build_probe(csrc, label.replace(" ", "_"))
        print(json.dumps(probe(so, label, args.bf16, dev)), flush=True)


if __name__ == "__main__":
    main()
