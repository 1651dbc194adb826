"""Kernel K5's plain version (sgnerf_tpu_torch/ops/fused_agg.py
`fused_block1_alpha_color_march`, CPU tensors) vs the JAX
fused_block1_alpha_color_march (Pallas, interpret mode on the CPU), and
render_rays with fused_march vs the reference's on the 3000-point sphere
scene of tests/test_fused_agg.py:210-256.

Tolerances: 2e-5 in f32 (summation order; the march's colour and
transmission are bounded by 1); 1e-2 in bf16 (a flipped bf16 rounding moves
a logit by up to ~1e-2 before the sigmoid); the render 1e-4 on colour and
background transmission, RENDER_ATOL of chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.ops.fused_agg import (
    fused_block1_alpha_color_march as jax_march)
from sgnerf_tpu_torch.models.params import params_from_jax
from sgnerf_tpu_torch.ops.fused_agg import fused_block1_alpha_color_march
from torch_threads import one_cpu_thread  # noqa: F401

K, NF, DF, VF = 8, 3, 5, 4


@pytest.fixture(scope="module")
def params():
    p = jagg.init_aggregator_params(jax.random.key(4), jagg.AggregatorConfig())
    return jax.tree.map(np.asarray, p)


def _inputs(seed, SR, n_rays=13, F=32, Dd=6):
    """n_rays * SR points with masked neighbour slots, dead points
    (ray_valid 0) and distances that leave rays from nearly clear to
    nearly opaque."""
    rng = np.random.default_rng(seed)
    M = n_rays * SR
    feat = (rng.normal(size=(M, K, F)) * 0.2).astype(np.float32)
    d = (rng.normal(size=(M, K, Dd)) * 0.05).astype(np.float32)
    w = (rng.random((M, K)) * (rng.random((M, K)) < 0.7)).astype(np.float32)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ray_dist = rng.uniform(0.05, 1.0, M).astype(np.float32)
    ray_valid = (rng.random(M) < 0.8).astype(np.float32)
    return feat, d, w, vd, ray_dist, ray_valid


@pytest.mark.parametrize("bf16,SR", [(False, 24), (True, 24), (False, 5)])
def test_plain_k5_matches_jax(params, bf16, SR):
    arrays = _inputs(int(bf16) + SR, SR)
    ref = jax_march(*(jnp.asarray(a) for a in arrays), params["block1"],
                    params["alpha_branch"], params["color_branch"], K=K,
                    nf=NF, df=DF, vf=VF, SR=SR, bf16=bf16)
    tp = params_from_jax(params)
    got = fused_block1_alpha_color_march(
        *(torch.from_numpy(a) for a in arrays), tp["block1"],
        tp["alpha_branch"], tp["color_branch"], K=K, nf=NF, df=DF, vf=VF,
        SR=SR, bf16=bf16)
    assert got.shape == (13, 4)
    # the rays are not all empty and not all opaque
    bgT = got[:, 3].numpy()
    assert bgT.min() < 0.9 and bgT.max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-2 if bf16 else 2e-5, rtol=0)


def test_k5_wrapper_needs_whole_rays(params):
    arrays = _inputs(0, 6)
    tp = params_from_jax(params)
    with pytest.raises(ValueError, match="multiple of SR"):
        fused_block1_alpha_color_march(
            *(torch.from_numpy(a) for a in arrays), tp["block1"],
            tp["alpha_branch"], tp["color_branch"], K=K, nf=NF, df=DF, vf=VF,
            SR=7, bf16=False)


@pytest.fixture(scope="module")
def sphere():
    """tests/test_fused_agg.py's sphere scene in both packages."""
    from sgnerf_tpu.models import point_cloud as jpc
    from sgnerf_tpu_torch.models import point_cloud as tpc
    rng = np.random.default_rng(9)
    n = 3000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    emb = (rng.normal(size=(n, 32)) * 0.1).astype(np.float32)
    color = np.clip(xyz * .5 + .5, 0, 1)
    kw = dict(vsize=[0.05] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
              max_o=8192, P=8)
    jc = jpc.make_point_cloud(xyz, emb, color=color, dir=xyz)
    tc = tpc.make_point_cloud(xyz, emb, color=color, dir=xyz)
    jg = jpc.build_grid(jc, jpc.grid_spec_for_cloud(jc, **kw))
    tg = tpc.build_grid(tc, tpc.grid_spec_for_cloud(tc, **kw))
    params = jax.tree.map(np.asarray, jagg.init_aggregator_params(
        jax.random.key(0), jagg.AggregatorConfig(fused_mlp="pallas")))
    d = (rng.normal(size=(2, 40, 3)) * 0.3).astype(np.float32)
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = dict(campos=np.tile(np.float32([0.0, 0.0, -3.0]), (2, 1)),
                raydir=d, camrotc2w=np.tile(np.eye(3, dtype=np.float32),
                                            (2, 1, 1)),
                bg_color=np.float32([1.0, 0.5, 0.25]))
    return (jc, jg), (tc, tg), params, rays


def test_render_rays_fused_march_matches_reference(sphere):
    from sgnerf_tpu.models.renderer import RenderConfig as JCfg
    from sgnerf_tpu.models.renderer import render_rays as jrender
    from sgnerf_tpu_torch.models.aggregator import AggregatorConfig
    from sgnerf_tpu_torch.models.renderer import RenderConfig, render_rays

    (jc, jg), (tc, tg), params, rays = sphere
    geo = dict(z_depth_dim=48, SR=8, K=4, vsize=(0.05,) * 3)
    jcfg = JCfg(agg=jagg.AggregatorConfig(fused_mlp="pallas",
                                          fused_march=True), **geo)
    tcfg = RenderConfig(agg=AggregatorConfig(fused_mlp="cuda",
                                             fused_march=True), **geo)
    jout = jrender(params, jc, jg, jcfg, near=1.0, far=5.0,
                   **{k: jnp.asarray(v) for k, v in rays.items()})
    tin = {k: torch.from_numpy(v) for k, v in rays.items()}
    tp = params_from_jax(params)
    with torch.inference_mode():
        tout = render_rays(tp, tc, tg, tcfg, near=1.0, far=5.0, **tin)
        full = render_rays(
            tp, tc, tg, RenderConfig(agg=AggregatorConfig(fused_mlp="cuda"),
                                     **geo), near=1.0, far=5.0, **tin)
    assert set(tout) == set(jout) == {
        "coarse_raycolor", "coarse_is_background", "queried_shading",
        "ray_mask", "ray_valid"}
    assert tout["ray_mask"].float().mean() > 0.3
    for key in ("coarse_raycolor", "coarse_is_background"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
        # and the port's own un-fused march
        np.testing.assert_allclose(tout[key].numpy(), full[key].numpy(),
                                   atol=1e-4, rtol=0, err_msg=key)
    for key in ("queried_shading", "ray_mask", "ray_valid"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)

    # the train path keeps the full per-sample outputs
    gen = torch.Generator().manual_seed(0)
    tr = render_rays(tp, tc, tg, tcfg, near=1.0, far=5.0, is_train=True,
                     generator=gen, **tin)
    assert "coarse_point_opacity" in tr and "coarse_depth" not in tr
