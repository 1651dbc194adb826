"""The fused aggregator's gate (sgnerf_tpu_torch/models/aggregator.py
`fused_paths`) and the kernels' shape predicates (ops/fused_agg.py
`k2_supports` .. `k4_supports`), on the CPU.

The reference's predicate picks the fused path for any K and width; the
port's kernels take a range of shapes (K2: C % 32 == 0, C <= 256, K <= 64;
K3: a block1 input of at most 288 columns; K4/K5: K <= 32; each a block
within the card's shared memory, which the CUDA library reports and the
gate asks on a CUDA device only). Outside a kernel's range the gate steps down:
K5 to K4 to K2 with the plain colour head, K2 to the un-fused path, and a
training forward takes the un-fused path where K3 cannot follow. The
option flags below are scene0113_00_default.sh's, as the port's CLIs
parse them, with the flags each case names; the card tests
(tests/test_torch_cuda.py) run the same shapes on the kernels and hold
the shared-memory clause there."""
import dataclasses

import pytest
import torch

from sgnerf_tpu_torch.ops import fused_agg
from chip_smoke import TRAIN_FLAGS
from sgnerf_tpu_torch.models.aggregator import (AggregatorConfig, aggregate,
                                                fused_paths,
                                                init_aggregator_params)
from sgnerf_tpu_torch.ops.fused_agg import (k2_supports, k3_supports,
                                            k4_supports)
from sgnerf_tpu_torch.options import TrainOptions, configs_from_opt

CANON = dict(F=32, Dd=6, nf=3, df=5, C=256)
# scene0113_00_default.sh's flags (K 8), as chip_smoke.py trains them
BASE = TRAIN_FLAGS


def _paths(flags, training=False, march=False, device="cpu"):
    """The path the gate picks for these train_ft flags."""
    opt = TrainOptions().parse(BASE + flags)
    cfg = configs_from_opt(opt, device="cuda")[0]
    agg = cfg.agg
    color = init_aggregator_params(0, agg)["color_branch"]
    return fused_paths(agg, K=cfg.K, F=agg.point_features_dim,
                       Dd=agg.dist_dim, color_branch=color,
                       training=training, device=device, march=march,
                       SR=cfg.SR)


@pytest.mark.parametrize("flags,want", [
    ([], "block1"),                                   # K 8
    (["--fused_color", "on"], "color"),
    (["--K", "2", "--fused_color", "on"], "color"),
    (["--K", "33", "--fused_color", "on"], "block1"),  # K4 takes K <= 32
    (["--shading_feature_num", "320"], "none"),       # K2 takes C <= 256
    (["--K", "96"], "none"),                          # K2 takes K <= 64
    (["--fused_mlp", "none", "--fused_color", "on"], "none"),
])
def test_gate_from_the_option_flags(flags, want):
    assert _paths(flags) == want
    if want != "none":   # K3 follows wherever the forward is fused
        assert _paths(flags, training=True) == want


@pytest.mark.parametrize("flags", [
    ["--which_agg_model", "viewmlp_yuze"],            # agg_variant
    ["--shading_feature_mlp_layer2", "1"],
    ["--shading_feature_mlp_layer3", "2"],            # scene0000_00.sh
    ["--agg_intrp_order", "1"],
    ["--agg_distance_kernel", "trilinear"],
    ["--agg_distance_kernel", "sh_intrp"],
    ["--agg_distance_kernel", "gau_intrp"],
], ids=["yuze", "layer2", "layer3", "order1", "trilinear", "sh_intrp",
        "gau_intrp"])
def test_gate_keeps_the_variants_unfused(flags):
    """The reference's gate (aggregator.py:489-501): the variants run the
    un-fused path with every kernel flag on, forward and training."""
    for extra in ([], ["--fused_color", "on"]):
        assert _paths(flags + extra) == "none"
        assert _paths(flags + extra, training=True) == "none"
    assert _paths(flags + ["--fused_march", "on"], march=True) == "none"


def test_gate_steps_the_march_down():
    """K5 runs eval renders where it fits; past K4's range the colour head
    and the march leave the kernel."""
    assert _paths(["--K", "8", "--fused_march", "on"], march=True) == "march"
    assert _paths(["--K", "8", "--fused_march", "on"]) == "block1"
    assert _paths(["--K", "33", "--fused_march", "on"],
                  march=True) == "block1"


def test_training_takes_the_unfused_path_where_k3_cannot_follow():
    """A 340-wide block1 input (F = 40): K2 runs it, K3 (<= 288) does not,
    so a training forward is un-fused unless the plain backward is asked
    for (--fused_bwd xla)."""
    flags = ["--point_features_dim", "40"]
    assert k2_supports(K=32, F=40, Dd=6, nf=3, df=5, C=256, bf16=False)
    assert not k3_supports(K=32, F=40, Dd=6, nf=3, df=5, C=256, bf16=False)
    assert _paths(flags) == "block1"
    assert _paths(flags, training=True) == "none"
    assert _paths(flags + ["--fused_bwd", "xla"], training=True) == "block1"


@pytest.mark.parametrize("bf16", [False, True])
def test_predicates_at_the_canonical_widths(bf16):
    """K2 and K3 take every K the gate sends them at the canonical widths;
    K4's shape clauses take K <= 32 (its shared memory is the card's
    question: tests/test_torch_cuda.py)."""
    for K in (1, 2, 8, 33, 64):
        assert k2_supports(K=K, bf16=bf16, **CANON)
        assert k3_supports(K=K, bf16=bf16, **CANON)
    assert not k2_supports(K=65, bf16=bf16, **CANON)
    assert not k2_supports(K=8, bf16=bf16, **dict(CANON, C=320))
    head = dict(vf=4, Nh=128, n_clayers=4)
    fits = [K for K in range(1, 40) if k4_supports(K=K, bf16=bf16, **CANON,
                                                   **head)]
    assert fits == list(range(1, 33))
    assert k4_supports(K=8, bf16=bf16, SR=24, **CANON, **head)
    assert not k4_supports(K=8, bf16=bf16, **CANON, **dict(head, Nh=2))


class _Lib:
    """The CUDA library's shared-memory queries: K2's block fits, K4's
    and K5's do not."""

    def __init__(self):
        self.asked = []

    def fused_block1_alpha_smem(self, *dims):
        self.asked.append("K2")
        return 200_000

    def fused_block1_alpha_color_smem(self, *dims):
        self.asked.append("K4")
        return 0


@pytest.mark.parametrize("flags,march,want", [
    (["--fused_color", "on"], False, "block1"),
    (["--fused_march", "on"], True, "block1"),
    (["--K", "2", "--fused_color", "on", "--compute_dtype", "bfloat16"],
     False, "block1"),
])
def test_gate_asks_the_card_for_shared_memory(monkeypatch, flags, march,
                                              want):
    """On a CUDA device the gate steps K4 and K5 down to K2 and the plain
    colour head when the library says their block exceeds shared memory;
    on the CPU (the plain versions) it asks nothing."""
    lib = _Lib()
    monkeypatch.setattr(fused_agg._cuda, "load", lambda name: lib)
    assert _paths(flags, march=march, device="cuda") == want
    assert lib.asked and set(lib.asked) == {"K2", "K4"}
    lib.asked.clear()
    assert _paths(flags, march=march) != want
    assert lib.asked == []


@pytest.mark.parametrize("K", [1, 2, 33, 96])
def test_aggregate_with_the_gate_runs_every_k_on_the_cpu(K):
    """aggregate() with --fused_mlp on and the colour head in the kernel
    runs at K 1, 2, 33 and 96 and gives the un-fused path's output (on the
    CPU every path is the kernels' plain statement)."""
    cfg = AggregatorConfig()
    fused = dataclasses.replace(cfg, fused_mlp="cuda", fused_color=True)
    g = torch.Generator().manual_seed(K)
    B, R, SR = 1, 3, 4

    def mk(*shape):
        return torch.randn(*shape, generator=g)
    kw = dict(sampled_embedding=mk(B, R, SR, K, 32) * 0.2,
              sampled_conf=mk(B, R, SR, K, 1).abs(),
              sampled_xyz=mk(B, R, SR, K, 3),
              sampled_xyz_pers=mk(B, R, SR, K, 3),
              sample_pnt_mask=mk(B, R, SR, K) > 0, sample_loc=mk(B, R, SR, 3),
              sample_loc_w=mk(B, R, SR, 3), sample_ray_dirs=mk(B, R, SR, 3),
              Rw2c=None, vsize=(0.008,) * 3)
    p = init_aggregator_params(0, cfg)
    got = aggregate(p, fused, **kw)[0]
    ref = aggregate(p, cfg, **kw)[0]
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
