"""Slab-sharded scenes (`--scene_shards`, sgnerf_tpu_torch/parallel/
spatial.py) against the JAX package's shard_map path and against the port
unsharded, on the CPU: the port's shards are CPU devices, the JAX mesh as
many of tests/conftest.py's virtual devices.

  * plan_sharded_scene: the selections and the SpatialSpec equal to JAX's
    (need_tables=True); with need_tables=False no world table is sized;
  * build_sharded_scene: every shard's occ_mask, dil_slot, row ids and
    cloud rows bit-equal to JAX's and its cache rows the same candidates
    within one rounding (JAX bins a slab's points shifted in float32),
    and over the voxels a slab owns its rows bit for bit the unsharded
    grid's, the boundary-spill case (query size above the kernel)
    included;
  * render_rays_spatial: colour atol 2e-5 / rtol 1e-4 and ray_mask equal
    (tests/test_spatial.py's limits) against JAX's and against the port
    unsharded, with the fused select (its plain version here) and the
    boundary spill;
  * the spatial train step, world, semantic-guided and perspective: losses
    within 1e-5 of the unsharded step's, parameter gradients within atol
    2e-5 / rtol 1e-3 and every point row's gradient (both copies of a halo
    point) within atol 1e-5 / rtol 1e-3 of the unsharded step's
    (tests/test_spatial.py's limits): the sum over shards, not n times it;
    held to JAX's spatial step too, but for the conf_coefficient of empty
    neighbour slots, where the JAX package's sharded step departs from its
    unsharded one (ROADMAP.md section 3);
  * the perspective render; spatial_train_step_multi against sequential
    unsharded steps (losses rtol 1e-4, parameters and point fields atol
    1e-5); SceneModel's wiring (train, save, prune, grow, render) against
    an unsharded model, and the semantics pushed into the slabs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_shard_scene as S
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.parallel import spatial as jsp
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.parallel import spatial as tsp
from torch_threads import one_cpu_thread  # noqa: F401

SPILL = dict(vsize=[0.06] * 3, vscale=[1, 1, 1], dilate_size=[5, 5, 5])
# the JAX package's sharded renders, compiled once a config (its SceneModel
# jits them too)
jrender = jax.jit(jsp.render_rays_spatial, static_argnums=(2, 3, 4))
jrender_pers = jax.jit(jsp.render_rays_spatial_perspective,
                       static_argnums=(2, 3, 4, 5))


@pytest.fixture(scope="module")
def pair():
    return S.make_pair(n=8000, semantic=True)


@pytest.fixture(scope="module")
def pair_bf16():
    return S.make_pair(n=8000, cache_dtype="bfloat16")


@pytest.fixture(scope="module")
def spill():
    """query_size 5 over kernel 3: the dilation reaches past the grid's
    kernel/2 margin into boundary shards' out-of-grid halo cells."""
    return S.make_pair(n=6000, seed=5, **SPILL)


def _scenes(p, n, **kw):
    jspec, tspec = p.jgrid.spec, p.tgrid.spec
    jsc, jss = jsp.build_sharded_scene(p.jcloud, jspec, n, **kw)
    from sgnerf_tpu.parallel import make_mesh as jmesh
    mesh = jmesh(n)
    return (jsp.shard_scene_put(jsc, mesh), jss, mesh,
            *tsp.build_sharded_scene(p.tcloud, tspec, n, **kw))


# ------------------------------------------------------------ plan, build

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", ["world", "spill"])
def test_plan_matches_jax(pair, spill, case, n):
    p = pair if case == "world" else spill
    xyz = np.asarray(p.jcloud.xyz)
    act = np.asarray(p.jcloud.active)
    cap = p.tcloud.capacity
    jss, jsel = jsp.plan_sharded_scene(xyz, act, p.jgrid.spec, n, cap,
                                       vox_bucket=1)
    tss, tsel = tsp.plan_sharded_scene(xyz, act, p.tgrid.spec, n, cap,
                                       vox_bucket=1)
    assert dataclasses.asdict(tss) == dataclasses.asdict(jss)
    for a, b in zip(tsel, jsel):
        np.testing.assert_array_equal(a, b)


def test_plan_without_tables_sizes_no_world_table(pair):
    """need_tables=False (the perspective path): no window is counted, so
    the world-table capacities stay at one bucket, where the JAX package
    still counts each shard's occupied voxels."""
    xyz, act = np.asarray(pair.jcloud.xyz), np.asarray(pair.jcloud.active)
    tss, tsel = tsp.plan_sharded_scene(xyz, act, pair.tgrid.spec, 2,
                                       pair.tcloud.capacity,
                                       need_tables=False)
    jss, jsel = jsp.plan_sharded_scene(xyz, act, pair.jgrid.spec, 2,
                                       pair.tcloud.capacity,
                                       need_tables=False)
    assert tss.max_o_s == tss.max_d_s == 8192
    assert (tss.cap_pts, tss.halo) == (jss.cap_pts, jss.halo)
    for a, b in zip(tsel, jsel):
        np.testing.assert_array_equal(a, b)


def _rows(packed, spec):
    """Cache rows -> (ids sorted a row, their offsets in that order, f32)."""
    from sgnerf_tpu_torch.ops.grid import unpack_cache
    off, ids = unpack_cache(torch.as_tensor(np.array(packed)), spec)
    ids, order = torch.sort(ids, -1)
    return ids, torch.gather(off.float(), -2,
                             order[..., None].expand(-1, -1, 3))


@pytest.mark.parametrize("case,n", [("world", 2), ("bf16", 3),
                                    ("spill", 2)])
def test_shard_tables_match_jax(pair, pair_bf16, spill, case, n):
    """The slabs' SpatialSpec, occ_mask, dil_slot, row ids and cloud rows
    bit-equal to JAX's; each cache row the same candidates, each offset
    within one rounding of the cache dtype of JAX's plus two float32 ulps
    of the scene's extent: the JAX build bins a slab's points shifted by
    x_off * vsize in float32 (its rows' order may differ at near ties),
    the port bins them in the global grid's voxels (its rows are the
    unsharded grid's, test_slab_rows_are_the_unsharded_grid_rows)."""
    p = {"world": pair, "bf16": pair_bf16, "spill": spill}[case]
    jsc, jss = jsp.build_sharded_scene(p.jcloud, p.jgrid.spec, n,
                                       vox_bucket=1)
    tsc, tss = tsp.build_sharded_scene(p.tcloud, p.tgrid.spec, n,
                                       vox_bucket=1)
    assert dataclasses.asdict(tss) == dataclasses.asdict(jss)
    bf16 = tss.lspec.cache_dtype == "bfloat16"
    shift_err = 2 * float(np.spacing(np.float32(
        np.abs(np.asarray(p.jcloud.xyz)[np.asarray(p.jcloud.active)]).max())))
    for i, s in enumerate(tsc.shards):
        for f in ("occ_mask", "dil_slot"):
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(jsc, f)[i]), f)
        np.testing.assert_array_equal(s.gid.numpy(), np.asarray(jsc.gid[i]))
        for f in ("xyz", "embedding", "conf", "color", "active", "label"):
            np.testing.assert_array_equal(
                getattr(s.cloud, f).numpy(),
                np.asarray(getattr(jsc.cloud, f)[i]), f)
        assert (s.x_off, s.own_lo, s.own_hi) == tuple(
            int(np.asarray(getattr(jsc, f)[i]))
            for f in ("x_off", "own_lo", "own_hi"))
        ids, off = _rows(s.nbr_packed, tss.lspec)
        jids, joff = _rows(jsc.nbr_packed[i], tss.lspec)
        assert torch.equal(ids, jids)
        ok = (ids >= 0)[..., None].expand_as(off)
        mag = joff.abs()[ok].numpy()
        ulp = (np.spacing(mag.astype(np.float32)) * (2 ** 16 if bf16 else 1))
        assert np.all(np.abs(off[ok].numpy() - joff[ok].numpy())
                      <= ulp + shift_err)
        # a slab holds fewer cache rows than the whole grid
        assert s.nbr_packed.shape[0] < p.tgrid.nbr_packed.shape[0]


@pytest.mark.parametrize("case,n", [("world", 3), ("spill", 2)])
def test_slab_rows_are_the_unsharded_grid_rows(pair, spill, case, n):
    """Over the voxels a slab owns, its dilated occupancy and cache slots
    are the unsharded grid's, and each cache row is the unsharded row bit
    for bit, its ids through the slab's row -> point map."""
    p = {"world": pair, "spill": spill}[case]
    tsc, tss = tsp.build_sharded_scene(p.tcloud, p.tgrid.spec, n)
    g = p.tgrid
    for s in tsc.shards:
        own = slice(s.own_lo, s.own_hi)
        loc = slice(s.own_lo - s.x_off, s.own_hi - s.x_off)
        assert torch.equal(s.occ_mask[loc], g.occ_mask[own])
        assert torch.equal(s.dil_slot[loc] >= 0, g.dil_slot[own] >= 0)
        have = g.dil_slot[own] >= 0
        ids, off = _rows(s.nbr_packed[s.dil_slot[loc][have].long()],
                         tss.lspec)
        gids, goff = _rows(g.nbr_packed[g.dil_slot[own][have].long()],
                           g.spec)
        mapped = torch.where(ids >= 0, s.gid[ids.clamp(min=0).long()], -1)
        mapped, order = torch.sort(mapped, -1)
        off = torch.gather(off, -2, order[..., None].expand(-1, -1, 3))
        assert torch.equal(mapped, gids.long())
        assert torch.equal(off, goff)


# ------------------------------------------------------------------ render

def _cam(b, conv):
    out = conv(b, ("campos", "raydir", "camrotc2w", "bg_color"))
    out.update(near=float(b["near"]), far=float(b["far"]))
    return out


@pytest.mark.parametrize("case,n", [("world", 2), ("world", 4),
                                    ("fused", 2), ("spill", 2)])
def test_spatial_render_matches_jax_and_unsharded(pair, pair_bf16, spill,
                                                  case, n):
    p = {"world": pair, "fused": pair_bf16, "spill": spill}[case]
    jcfg, tcfg = S.configs(**(dict(knn_mode="fused") if case == "fused"
                              else {}))
    jsc, jss, mesh, tsc, tss = _scenes(p, n)
    b = S.rays(256)
    jout = jrender(p.jparams, jsc, jss, jcfg, mesh, **_cam(b, S.jax_batch))
    cam = _cam(b, S.torch_batch)
    with torch.no_grad():
        got = tsp.render_rays_spatial(p.tparams, tsc, tss, tcfg, **cam)
        ref = tren.render_rays(p.tparams, p.tcloud, p.tgrid, tcfg, **cam)
    assert int(ref["ray_mask"].sum()) > 64
    for want, what in ((ref, "unsharded"), (jout, "jax")):
        np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                      np.asarray(want["ray_mask"]), what)
        for k in ("coarse_raycolor", "coarse_point_opacity",
                  "coarse_is_background"):
            S.close(got[k], want[k], f"{k} vs {what}")


def test_spatial_perspective_render_matches_jax_and_unsharded(pair):
    jps, tps = S.pspecs()
    jcfg, tcfg = S.configs()
    halo = tsp.perspective_halo_voxels(pair.tgrid.spec, tps)
    assert halo == jsp.perspective_halo_voxels(pair.jgrid.spec, jps) > 2
    jsc, jss, mesh, tsc, tss = _scenes(pair, 2, halo_override=halo,
                                       build_tables=False)
    b = S.rays(256, seed=31)
    jout = jrender_pers(pair.jparams, jsc, jss, jps, jcfg, mesh,
                        **_cam(b, S.jax_batch))
    cam = _cam(b, S.torch_batch)
    with torch.no_grad():
        got = tsp.render_rays_spatial_perspective(pair.tparams, tsc, tss,
                                                  tps, tcfg, **cam)
        ref = tren.render_rays_perspective(pair.tparams, pair.tcloud, tps,
                                           tcfg, **cam)
    assert int(ref["ray_mask"].sum()) > 32
    for want, what in ((ref, "unsharded"), (jout, "jax")):
        np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                      np.asarray(want["ray_mask"]), what)
        S.close(got["coarse_raycolor"], want["coarse_raycolor"], what)


def test_spatial_render_two_level_matches_unsharded():
    """With the two-level compaction on (coarse_factor 4, as the CLIs pick
    it for the canonical flags) the slabs' united hits go through the
    global supervoxel table as the unsharded path's samples do (the JAX
    package's sharded path compacts flat)."""
    p = S.make_pair(n=6000, coarse_factor=4, seg_len=4, seg_cap=24)
    _, tcfg = S.configs()
    tsc, tss = tsp.build_sharded_scene(p.tcloud, p.tgrid.spec, 3)
    assert tsc.coarse_occ is not None
    np.testing.assert_array_equal(tsc.coarse_occ.numpy(),
                                  p.tgrid.coarse_occ.numpy())
    cam = _cam(S.rays(256, seed=3), S.torch_batch)
    with torch.no_grad():
        got = tsp.render_rays_spatial(p.tparams, tsc, tss, tcfg, **cam)
        ref = tren.render_rays(p.tparams, p.tcloud, p.tgrid, tcfg, **cam)
    np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                  ref["ray_mask"].numpy())
    S.close(got["coarse_raycolor"], ref["coarse_raycolor"], "colour")


def test_perspective_slabs_keep_the_frame_grid_points():
    """A cloud four slabs long and a frame grid that keeps 2800 of its 3279
    occupied frustum voxels (the first max_o in voxel order, 2 points
    each): each slab's frame grid holds the points the whole cloud's grid
    keeps, so the render is the unsharded one; a slab grid over all its
    own points keeps other voxels (it counts only its own) and renders
    otherwise."""
    from sgnerf_tpu_torch.models import aggregator as tagg
    from sgnerf_tpu_torch.models import point_cloud as tpc
    from sgnerf_tpu_torch.ops.query_pers import perspective_spec_from_camera
    rng = np.random.default_rng(8)
    n = 6000
    xyz = np.stack([rng.uniform(-3.5, 3.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(0.5, 1.5, n)], -1).astype(np.float32)
    cloud = tpc.make_point_cloud(
        xyz, (rng.normal(size=(n, 32)) * 0.1).astype(np.float32),
        conf=rng.uniform(0.3, 1.0, (n, 1)), color=rng.uniform(0, 1, (n, 3)),
        dir=np.tile(np.float32([0, 0, -1]), (n, 1)))
    spec = tpc.grid_spec_for_cloud(cloud, vsize=[0.08] * 3, vscale=[2, 2, 2],
                                   kernel_size=[3, 3, 3], max_o=65536, P=16)
    pspec = perspective_spec_from_camera(
        S.INTR, S.W, S.H, near=1.0, far=5.0, vsize=[0.06] * 3,
        vscale=[1, 1, 1], kernel_size=[3, 3, 3], max_o=2800, P=2)
    _, tcfg = S.configs()
    params = tagg.init_aggregator_params(1, tcfg.agg, "cpu")
    tsc, tss = tsp.build_sharded_scene(
        cloud, spec, 4, build_tables=False,
        halo_override=tsp.perspective_halo_voxels(spec, pspec))
    assert max(s.n_rows for s in tsc.shards) < n
    cam = _cam(S.rays(256, seed=9), S.torch_batch)
    with torch.no_grad():
        ref = tren.render_rays_perspective(params, cloud, pspec, tcfg, **cam)
        got = tsp.render_rays_spatial_perspective(params, tsc, tss, pspec,
                                                  tcfg, **cam)
        own = tsp.render_rays_spatial_perspective(
            params, dataclasses.replace(tsc, points=None), tss, pspec, tcfg,
            **cam)
    assert int(ref["ray_mask"].sum()) > 64
    np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                  ref["ray_mask"].numpy())
    S.close(got["coarse_raycolor"], ref["coarse_raycolor"], "colour")
    assert float((own["coarse_raycolor"]
                  - ref["coarse_raycolor"]).abs().max()) > 1e-3


# ---------------------------------------------------------------- training

def _jax_spatial_noise(key, jcfg, B, R, C, perspective):
    """The draws of the JAX package's sharded forward for `key`:
    render_rays_perspective's on the perspective path; on the world path
    raygen from split(key)[0] and the guided query's uniforms from
    split(key)[1] over the cache's C candidates."""
    if perspective:
        return S.port_noise(jren.draw_render_noise(
            key, jcfg, B, R, perspective=True, is_train=True))
    kj, ks = jax.random.split(key)
    return {"raygen_u": torch.from_numpy(np.array(jax.random.uniform(
                kj, (B, R, jcfg.z_depth_dim)))),
            "guide_u": torch.from_numpy(np.array(jax.random.uniform(
                ks, (B, R, jcfg.SR, C))))}


@pytest.mark.parametrize("case", ["world", "semantic", "perspective"])
def test_spatial_train_step_matches_jax_and_unsharded(pair, case):
    """One step over 2 slabs: the losses, the parameter gradients and each
    shard row's point gradient (halo copies both) against the unsharded
    step's gradients, and the losses and gradients of JAX's step."""
    n = 2
    sem = case == "semantic"
    jcfg, tcfg = S.configs(semantic_guidance=int(sem),
                           jitter=0.0 if sem else 0.3)
    jps, tps = S.pspecs() if case == "perspective" else (None, None)
    kw = (dict(halo_override=tsp.perspective_halo_voxels(pair.tgrid.spec,
                                                         tps),
               build_tables=False) if tps is not None else {})
    jsc, jss, mesh, tsc, tss = _scenes(pair, n, **kw)
    b = S.rays(128, seed=21)
    if not sem:
        b.pop("pixel_label")
    key = jax.random.key(4)
    noise = _jax_spatial_noise(key, jcfg, 1, 128, pair.tgrid.spec.nbr_cache,
                               tps is not None)
    if not sem:
        noise.pop("guide_u", None)
    from sgnerf_tpu.models.train import TrainConfig as JTC
    jst = jsp.create_spatial_train_state(pair.jparams, jsc, JTC())
    _, jl, (jg_net, jg_pts) = jsp.spatial_train_step(
        jst, jss, jcfg, JTC(), S.jax_batch(b), key, mesh, return_grads=True,
        pspec=jps)

    tc = ttrain.TrainConfig()
    import copy
    st = tsp.create_spatial_train_state(copy.deepcopy(pair.tparams), tsc, tc)
    _, tl, (g_net, g_pts) = tsp.spatial_train_step(
        st, tss, tcfg, tc, S.torch_batch(b), noise=noise, pspec=tps,
        return_grads=True)
    ref = ttrain.create_train_state(copy.deepcopy(pair.tparams),
                                    copy.deepcopy(pair.tcloud), tc)
    rl, r_net, r_pts = ttrain.loss_and_grads(ref, pair.tgrid, tcfg, tc,
                                             S.torch_batch(b), noise=noise,
                                             pspec=tps)
    assert sorted(tl) == sorted(rl) == sorted(jl)
    for k in rl:
        assert abs(float(tl[k]) - float(rl[k])) < 1e-5, k
    # the JAX package's sharded step zeroes the conf_coefficient of the
    # neighbour slots no shard owns and gives the owned empty ones its
    # shards' row 0 (the port gives both point 0's, as the unsharded
    # step): its zero-one loss, its total and the conf gradient of those
    # rows differ; everything else is held to it
    for k in set(jl) - {"conf_coefficient", "total"}:
        assert abs(float(tl[k]) - float(jl[k])) < 1e-5, k
    assert abs(float(tl["conf_coefficient"])
               - float(jl["conf_coefficient"])) > 1e-3
    jleaves = jax.tree.leaves(jg_net)
    from sgnerf_tpu_torch.models.params import params_to_jax
    tleaves = jax.tree.leaves(params_to_jax(
        _as_tree(pair.tparams, g_net)))
    for a, r in zip(g_net, r_net):
        S.close(a, r, "param grad vs unsharded", atol=2e-5, rtol=1e-3)
    for a, j in zip(tleaves, jleaves):
        S.close(a, j, "param grad vs jax", atol=2e-5, rtol=1e-3)
    fields = ttrain.trained_fields(tc)
    gids = [s.gid[:s.n_rows].numpy() for s in tsc.shards]
    assert sum(map(len, gids)) > len(np.unique(np.concatenate(gids)))
    for i, s in enumerate(tsc.shards):
        rows = gids[i]
        for k, f in enumerate(fields):
            got = g_pts[i][k][:s.n_rows].numpy()
            S.close(got, r_pts[k][rows], f"{f} shard {i}", atol=1e-5,
                    rtol=1e-3)
            keep = (np.arange(s.n_rows) > 0) & (rows != 0) \
                if f == "conf" else slice(None)
            S.close(got[keep], np.asarray(jg_pts[f][i])[:s.n_rows][keep],
                    f"{f} vs jax", atol=1e-5, rtol=1e-3)


def _as_tree(params, leaves):
    """Gradient leaves in param_leaves order -> params' tree."""
    it = iter(leaves)
    return {blk: [{k: next(it) for k in ("w", "b")} for _ in params[blk]]
            for blk in sorted(params)}


def test_spatial_jittered_perspective_step_matches_unsharded(pair):
    """--shpnt_jitter uniform: the slabs query before the jitter and shade
    at the jittered points, as the unsharded path does."""
    _, tcfg = S.configs(shpnt_jitter="uniform")
    _, tps = S.pspecs()
    tsc, tss = tsp.build_sharded_scene(
        pair.tcloud, pair.tgrid.spec, 3, build_tables=False,
        halo_override=tsp.perspective_halo_voxels(pair.tgrid.spec, tps))
    b = S.torch_batch(S.rays(128, seed=41))
    b.pop("pixel_label")
    noise = tren.draw_render_noise(torch.Generator().manual_seed(2), tcfg,
                                   1, 128, perspective=True)
    assert "shade_u" in noise
    tc = ttrain.TrainConfig()
    import copy
    st = tsp.create_spatial_train_state(copy.deepcopy(pair.tparams), tsc, tc)
    _, tl, (g_net, _) = tsp.spatial_train_step(
        st, tss, tcfg, tc, b, noise=noise, pspec=tps, return_grads=True)
    ref = ttrain.create_train_state(copy.deepcopy(pair.tparams),
                                    copy.deepcopy(pair.tcloud), tc)
    rl, r_net, _ = ttrain.loss_and_grads(ref, pair.tgrid, tcfg, tc, b,
                                         noise=noise, pspec=tps)
    assert abs(float(tl["total"]) - float(rl["total"])) < 1e-5
    for a, r in zip(g_net, r_net):
        S.close(a, r, "param grad", atol=2e-5, rtol=1e-3)


def test_spatial_multi_step_matches_sequential_steps(pair):
    _, tcfg = S.configs()
    tc = ttrain.TrainConfig()
    import copy
    tsc, tss = tsp.build_sharded_scene(copy.deepcopy(pair.tcloud),
                                       pair.tgrid.spec, 2)
    st = tsp.create_spatial_train_state(copy.deepcopy(pair.tparams), tsc, tc)
    batches = []
    for i in range(3):
        b = S.torch_batch(S.rays(128, seed=50 + i))
        b.pop("pixel_label")
        batches.append(b)
    st, ml = tsp.spatial_train_step_multi(
        st, tss, tcfg, tc, batches, generator=torch.Generator().manual_seed(1))
    seq = ttrain.create_train_state(copy.deepcopy(pair.tparams),
                                    copy.deepcopy(pair.tcloud), tc)
    gen = torch.Generator().manual_seed(1)
    for b, got in zip(batches, ml):
        seq, sl = ttrain.train_step(seq, pair.tgrid, tcfg, tc, b,
                                    generator=gen)
        np.testing.assert_allclose(float(got["total"]), float(sl["total"]),
                                   rtol=1e-4)
    assert st.step == seq.step == 3
    for k, (a, r) in enumerate(zip(ttrain.param_leaves(st.params),
                                   ttrain.param_leaves(seq.params))):
        S.close(a, r, f"param {k}", atol=1e-5, rtol=0)
    for s in tsc.shards:
        rows = s.gid[:s.n_rows]
        for f in ttrain.trained_fields(tc):
            S.close(getattr(s.cloud, f)[:s.n_rows],
                    getattr(seq.cloud, f)[rows], f, atol=1e-5, rtol=0)


# -------------------------------------------------------------- SceneModel

def test_scene_model_scene_shards_wiring(tmp_path):
    sharded, plain = S.wiring(S.scene_models(
        tmp_path, ["--scene_shards", "2", "--gpu_ids", "-1,-1"]))
    assert sharded.sharded_scene is not None and plain.sharded_scene is None
    # the grow re-cut the slabs over the grown cloud
    n_rows = sum(s.n_rows for s in sharded.sharded_scene.shards)
    assert n_rows >= int(sharded.cloud.n_active)
    assert sharded.sspec.n_global == sharded.cloud.capacity
    assert (tmp_path / "0" / "rd" / "3_net_ray_marching.npz").exists()


def test_scene_model_syncs_and_pushes_semantics(tmp_path):
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    m, _ = S.scene_models(tmp_path, ["--scene_shards", "3",
                                     "--gpu_ids", "-1,-1,-1"])
    before = m.state.cloud.embedding.clone()
    m.optimize(batch_to_device(S.frame(1), "cpu"))
    assert torch.equal(m.state.cloud.embedding, before)     # not yet read
    after = m.cloud.embedding                                # folds back
    assert not torch.equal(after, before)
    for s in m.sharded_scene.shards:
        rows = s.gid[:s.n_rows]
        assert torch.equal(s.cloud.embedding[:s.n_rows], after[rows])
    n = int(m.cloud.n_active)
    rng = np.random.default_rng(2)
    probs = torch.from_numpy(rng.dirichlet(np.ones(20), n).astype(np.float32))
    m.set_semantics(probs, probs.argmax(-1),
                    torch.from_numpy(rng.normal(size=(n, 96)).astype(
                        np.float32)))
    for s in m.sharded_scene.shards:
        rows = s.gid[:s.n_rows]
        for f in ("label", "label_prob", "sem_embedding"):
            assert torch.equal(getattr(s.cloud, f)[:s.n_rows],
                               getattr(m.cloud, f)[rows]), f


def test_scene_model_perspective_scene_shards_render(tmp_path):
    """--wcoord_query 0 with --scene_shards: the slabs wait for the frustum
    spec, then the frame equals the unsharded model's."""
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    sharded, plain = S.scene_models(
        tmp_path, ["--scene_shards", "2", "--gpu_ids", "-1,-1",
                   "--wcoord_query", "0", "--img_wh", str(S.FW),
                   str(S.FH)])
    assert sharded.sharded_scene is None             # waits for the pspec
    with pytest.raises(RuntimeError, match="ensure_pspec"):
        sharded.optimize(batch_to_device(S.frame(), "cpu"))
    item = S.frame()
    cols = [m.render_image(item, chunk_rays=64) for m in (sharded, plain)]
    assert sharded.sharded_scene is not None
    S.close(cols[0], cols[1], "perspective frame")
    losses = [float(m.optimize(batch_to_device(S.frame(3), "cpu"))["total"])
              for m in (sharded, plain)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
