"""Ray data parallelism (`--ray_shards`, sgnerf_tpu_torch/parallel/) against
the JAX package's shard_map path and against the port unsharded, on the
CPU: the port's shards are CPU devices, the JAX mesh as many of
tests/conftest.py's virtual devices.

  * render_rays_sharded, world and perspective, 2 and 4 shards: colour
    atol 2e-5 / rtol 1e-4 and ray_mask equal (tests/test_spatial.py's
    limits), against JAX's sharded render and the port unsharded;
  * the sharded train step against JAX's sharded_train_step (the port fed
    JAX's noise) and against the port unsharded: losses rtol 1e-4 and the
    MLP parameters atol 1e-5 (tests/test_parallel.py's limits), the
    summed batchdedup overflow equal to JAX's psum; train_step_multi over
    the shards against sequential unsharded steps, the same limits;
  * the growing probes' render over the shards against the unsharded one,
    and SceneModel's wiring (train, save, prune, grow, render) against an
    unsharded model;
  * ShardGroup itself, and the flags: fewer --gpu_ids than shards and both
    kinds of shards at once raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_scene as S
from sgnerf_tpu.models import train as jtrain
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.parallel import ShardGroup, render_rays_sharded
from torch_threads import one_cpu_thread  # noqa: F401

CAM = ("campos", "raydir", "camrotc2w", "bg_color")


@pytest.fixture(scope="module")
def pair():
    return S.make_pair(n=12000, vsize=[0.05] * 3)


def _cam(b, conv):
    out = conv(b, CAM)
    out.update(near=float(b["near"]), far=float(b["far"]))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("path", ["world", "perspective"])
def test_ray_dp_render_matches_jax_and_unsharded(pair, path, n):
    from sgnerf_tpu.parallel import make_mesh as jmesh, sharded_render
    jcfg, tcfg = S.configs()
    b = S.rays(256)
    jps, tps = S.pspecs() if path == "perspective" else (None, None)
    jout = sharded_render(pair.jparams, pair.jcloud, pair.jgrid, jcfg,
                          jmesh(n), pspec=jps, **_cam(b, S.jax_batch))
    cam = _cam(b, S.torch_batch)
    with torch.no_grad():
        got = render_rays_sharded(pair.tparams, pair.tcloud, pair.tgrid,
                                  tcfg, S.cpu_group(n), pspec=tps, **cam)
        if tps is None:
            ref = tren.render_rays(pair.tparams, pair.tcloud, pair.tgrid,
                                   tcfg, **cam)
        else:
            ref = tren.render_rays_perspective(pair.tparams, pair.tcloud,
                                               tps, tcfg, **cam)
    assert int(ref["ray_mask"].sum()) > 64        # the shell fills the view
    for want, what in ((ref, "unsharded"), (jout, "jax")):
        np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                      np.asarray(want["ray_mask"]), what)
        S.close(got["coarse_raycolor"], want["coarse_raycolor"], what)
        S.close(got["coarse_point_opacity"], want["coarse_point_opacity"],
                what)


def _states(pair, tc):
    """A fresh port TrainState on copies of the pair's params and cloud."""
    import copy
    return ttrain.create_train_state(copy.deepcopy(pair.tparams),
                                     copy.deepcopy(pair.tcloud), tc)


def _params_close(got, want_tree, atol=1e-5):
    for block, layers in want_tree.items():
        for li, layer in enumerate(layers):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    got[block][li][k].numpy(), np.asarray(layer[k]), rtol=0,
                    atol=atol, err_msg=f"{block}.{li}.{k}")


@pytest.mark.parametrize("vjp", ["scatter", "batchdedup"])
def test_ray_dp_train_step_matches_jax_and_unsharded(pair, vjp):
    """One step on 2 shards. batchdedup with 200 distinct ids kept a
    shard's batch drops rows on every shard: the overflow is each shard's
    count summed, in both packages (the unsharded step keeps 200 of the
    whole batch's ids: another count, other dropped rows; its forward is
    the same)."""
    from sgnerf_tpu.parallel import make_mesh as jmesh, sharded_train_step
    kw = dict(gather_vjp=vjp, gvjp_batch_U=200 if vjp == "batchdedup" else 0)
    jcfg, tcfg = S.configs(**kw)
    b = S.rays(128, seed=21)
    b.pop("pixel_label")
    key = jax.random.key(7)
    jtc, tc = jtrain.TrainConfig(), ttrain.TrainConfig()
    # the JAX step donates its state: copies, so the pair's arrays live on
    jst = jtrain.create_train_state(
        *jax.tree.map(jnp.array, (pair.jparams, pair.jcloud)), jtc)
    jst, jl = sharded_train_step(jst, pair.jgrid, jcfg, jtc,
                                 S.jax_batch(b), key, jmesh(2))
    noise = S.port_noise(jren.draw_render_noise(
        key, jcfg, 1, 128, grid=pair.jgrid, is_train=True))
    runs = {}
    for name, mesh in (("sharded", S.cpu_group(2)), ("unsharded", None)):
        st, losses = ttrain.train_step(_states(pair, tc), pair.tgrid, tcfg,
                                       tc, S.torch_batch(b), noise=noise,
                                       ray_mesh=mesh)
        runs[name] = (st, losses)
    st, tl = runs["sharded"]
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-4, err_msg=k)
        if k != "gvjp_overflow":
            np.testing.assert_allclose(tl[k].numpy(),
                                       runs["unsharded"][1][k].numpy(),
                                       rtol=1e-4, err_msg=k)
    _params_close(st.params, jax.tree.map(np.asarray, jst.params))
    if vjp == "batchdedup":
        assert float(tl["gvjp_overflow"]) > 0
        return
    _params_close(st.params, runs["unsharded"][0].params)
    for f in ttrain.trained_fields(tc):
        np.testing.assert_allclose(
            getattr(st.cloud, f).numpy(),
            getattr(runs["unsharded"][0].cloud, f).numpy(), rtol=0,
            atol=1e-5, err_msg=f)


def test_train_step_multi_over_shards_equals_sequential_steps(pair):
    _, tcfg = S.configs()
    tc = ttrain.TrainConfig()
    batches = []
    for i in range(2):
        b = S.rays(128, seed=30 + i)
        b.pop("pixel_label")
        batches.append(S.torch_batch(b))
    multi, ml = ttrain.train_step_multi(
        _states(pair, tc), pair.tgrid, tcfg, tc, batches,
        generator=torch.Generator().manual_seed(3), ray_mesh=S.cpu_group(4))
    seq, gen = _states(pair, tc), torch.Generator().manual_seed(3)
    for b, got in zip(batches, ml):
        seq, sl = ttrain.train_step(seq, pair.tgrid, tcfg, tc, b,
                                    generator=gen)
        for k in sl:
            np.testing.assert_allclose(got[k].numpy(), sl[k].numpy(),
                                       rtol=1e-4, err_msg=k)
    _params_close(multi.params, seq.params)
    for f in ttrain.trained_fields(tc):
        np.testing.assert_allclose(getattr(multi.cloud, f).numpy(),
                                   getattr(seq.cloud, f).numpy(), rtol=0,
                                   atol=1e-5, err_msg=f)


# ------------------------------------------------------------- SceneModel

def test_scene_model_ray_shards_wiring(tmp_path):
    sharded, plain = S.wiring(S.scene_models(
        tmp_path, ["--ray_shards", "2", "--gpu_ids", "-1,-1"]))
    assert sharded.ray_mesh.size == 2 and plain.ray_mesh is None
    assert (tmp_path / "0" / "rd" / "3_net_ray_marching.npz").exists()
    assert int(sharded.cloud.n_active) == int(plain.cloud.n_active)


def test_probe_render_over_shards_matches_unsharded(tmp_path):
    from sgnerf_tpu_torch.runtime.growing import PROBE_KEYS, render_probe_maps
    sharded, plain = S.scene_models(
        tmp_path, ["--ray_shards", "3", "--gpu_ids", "-1,-1,-1"])
    got = render_probe_maps(sharded, S.frame(), chunk_rays=64)
    want = render_probe_maps(plain, S.frame(), chunk_rays=64)
    assert want["ray_mask"].any()
    np.testing.assert_array_equal(got["ray_mask"], want["ray_mask"])
    for k in PROBE_KEYS:
        S.close(got[k], want[k], k)


# ------------------------------------------------------------ ShardGroup

def test_replicate_sums_the_shards_gradients_in_shard_order():
    g = ShardGroup(["cpu"] * 3)
    t = torch.arange(4.0, requires_grad=True)
    parts = g.replicate(t)
    assert len(parts) == 3
    sum((i + 1) * p for i, p in enumerate(parts)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full(4, 6.0))
    x = torch.arange(10.0)[None, :, None]
    blocks = g.split_rays(x)
    assert [b.shape[1] for b in blocks] == [4, 3, 3]
    np.testing.assert_array_equal(g.cat_rays(blocks).numpy(), x.numpy())
    assert float(g.psum([torch.tensor(1.0)] * 3)) == 3.0


def test_copies_kept_until_the_source_changes():
    """A copy to another device (here the data-less meta device) is made
    once and kept while the source is unchanged; an in-place update of the
    source (its version counter) makes a new one. Shards on the source's
    own device get the source itself."""
    g = ShardGroup(["cpu", "meta", "cpu"])
    t = torch.zeros(3)
    a = g.copies(t)
    assert a[1].device.type == "meta" and torch.equal(a[0], t)
    assert g.copies(t)[1] is a[1]
    t.add_(1)
    b = g.copies(t)
    assert b[1] is not a[1] and torch.equal(b[2], t)


@pytest.mark.parametrize("flags,err", [
    (["--ray_shards", "2"], "--gpu_ids"),
    (["--scene_shards", "2"], "--gpu_ids"),
    (["--ray_shards", "4", "--gpu_ids", "-1,-1"], "--gpu_ids"),
    (["--ray_shards", "2", "--scene_shards", "2", "--gpu_ids", "-1,-1"],
     "mutually exclusive"),
    (["--ray_shards", "-1", "--gpu_ids", "-1,-1,-1"], None),
])
def test_shard_flags_take_one_device_a_shard(tmp_path, flags, err):
    """Fewer --gpu_ids than shards, and both kinds of shards at once, raise
    (in configs_from_opt, which both CLIs call first, and in SceneModel);
    --ray_shards -1 takes one shard a listed id."""
    from sgnerf_tpu_torch.options import TrainOptions, configs_from_opt
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    opt = TrainOptions().parse(S.FLAGS + ["--checkpoints_dir", str(tmp_path)]
                               + flags)
    if err is None:
        assert SceneModel(opt, device="cpu").ray_mesh.size == 3
        return
    with pytest.raises(ValueError, match=err):
        configs_from_opt(opt, device="cpu")
    with pytest.raises(ValueError, match=err):
        SceneModel(opt, device="cpu")
