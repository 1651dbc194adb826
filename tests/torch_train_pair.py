"""The bf16 limit of a gather transpose, and one train step of a tiny scene
in both packages on the same noise, for the opt-in gathers' parity tests (tests/test_torch_gather_vjp.py,
tests/test_torch_quant.py): the JAX package's train_step against the
port's, the port's noise taken from JAX's draws (raygen_u, and sr_bits =
jax.random.bits(noise["kg"], table shape, uint16)).

Tolerances are tests/test_torch_train.py's: losses rtol 1e-5, the MLPs and
the trained point fields after Adam rtol 2e-3, atol 2e-6.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.models import train as jtrain
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.models import train as ttrain
from sgnerf_tpu_torch.models.params import params_from_jax

GRID = dict(vsize=[0.08] * 3, vscale=[1, 1, 1], kernel_size=[3, 3, 3],
            max_o=8192, P=16)
RENDER = dict(z_depth_dim=48, SR=6, K=4, vsize=(0.08,) * 3)
TRAIN = dict(color_grad=1)


def bf16_ulp(x):
    """One bf16 ulp at magnitude x (8 significant bits); 0 at 0."""
    x = np.asarray(x, np.float64)
    e = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (e - 7), 0.0)


def tolerance(idx: np.ndarray, cot: np.ndarray, per_column=False):
    """The bf16 limit of a transpose's table gradient (BF16_ULPS): the
    largest count of one id's duplicates (rows of zero cotangent add no
    rounding) times a bf16 ulp of the largest sum of |cotangent| over one
    id's rows; for the whole table, or for each column."""
    flat = idx.reshape(-1)
    rows = np.abs(cot.reshape(flat.shape[0], -1).astype(np.float64))
    sums = np.zeros((flat.max() + 1, rows.shape[1]))
    np.add.at(sums, flat, rows)
    dups = np.zeros_like(sums)
    np.add.at(dups, flat, rows > 0)
    if per_column:
        return dups.max(axis=0) * bf16_ulp(sums.max(axis=0))
    return float(dups.max() * bf16_ulp(sums.max()))


def scene(R=32):
    """The JAX cloud (600 points on a sphere, capacity 640), its grid,
    seeded aggregator weights and a batch of R rays."""
    n, cap = 600, 640
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    jcloud = jpc.make_point_cloud(
        xyz, rng.normal(size=(n, 32)).astype(np.float32) * 0.1,
        conf=rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
        color=rng.uniform(0, 1, (n, 3)).astype(np.float32), dir=xyz,
        capacity=cap)
    jgrid = jpc.build_grid(jcloud, jpc.grid_spec_for_cloud(jcloud, **GRID))
    jparams = jagg.init_aggregator_params(
        jax.random.key(0), jagg.AggregatorConfig(fused_mlp="none"))
    d = rng.normal(size=(1, R, 3)).astype(np.float32) * 0.25
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"campos": np.asarray([[0.0, 0.0, -3.0]], np.float32),
             "raydir": d, "camrotc2w": np.eye(3, dtype=np.float32)[None],
             "near": np.float32(1.0), "far": np.float32(5.0),
             "bg_color": np.ones(3, np.float32),
             "gt_image": rng.uniform(0.2, 0.8, (1, R, 3)).astype(np.float32)}
    return jcloud, jgrid, jparams, batch


def configs(cfg_kw):
    jcfg = jren.RenderConfig(agg=jagg.AggregatorConfig(
        fused_mlp="none", fused_bwd="xla"), **RENDER, **cfg_kw)
    return jcfg, tren.RenderConfig(agg=tagg.AggregatorConfig(), **RENDER,
                                   **cfg_kw)


def port_side(jcloud, jparams):
    """The port's cloud, train state and grid from the JAX ones."""
    tcloud = tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")
    tstate = ttrain.create_train_state(
        params_from_jax(jax.tree.map(np.asarray, jparams)), tcloud,
        ttrain.TrainConfig(**TRAIN))
    tgrid = tpc.build_grid(tcloud, tpc.grid_spec_for_cloud(tcloud, **GRID))
    return tcloud, tstate, tgrid


def port_noise(jcfg, jgrid, tcloud, R, key):
    """JAX's draws for one step as the port's noise dict."""
    jn = jren.draw_render_noise(key, jcfg, 1, R, grid=jgrid, is_train=True)
    shape = (tcloud.capacity, tren.table_width(tcloud))
    return {"raygen_u": torch.from_numpy(np.array(jn["raygen_u"])),
            "sr_bits": torch.from_numpy(np.array(jax.random.bits(
                jn["kg"], shape, jnp.uint16)).view(np.int16))}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@contextlib.contextmanager
def recording_cotangents(seen):
    """Append (ids, cotangent rows) of each attribute gather's backward to
    `seen` (the transposes' and the int8 gather's)."""
    orig_t, orig_8 = tren.gather_transpose, tren.gather_rows_int8

    def transpose(cfg, rows):
        t = orig_t(cfg, rows)

        def run(flat, g, n):
            seen.append((flat.numpy(), g.float().numpy()))
            return t(flat, g, n)
        return run

    def int8(table, idx, active):
        out = orig_8(table, idx, active)
        out.register_hook(lambda g: seen.append(
            (idx.reshape(-1).numpy(),
             g.reshape(idx.numel(), -1).float().numpy())))
        return out
    tren.gather_transpose, tren.gather_rows_int8 = transpose, int8
    try:
        yield seen
    finally:
        tren.gather_transpose, tren.gather_rows_int8 = orig_t, orig_8


def train_step_pair(cfg_kw, key_seed=5):
    """One train step in both packages on the same scene and draws.
    Returns (JAX losses, port losses, JAX state, port state, the port's
    gather cotangents)."""
    jcloud, jgrid, jparams, batch = scene()
    jcfg, tcfg = configs(cfg_kw)
    tcloud, tstate, tgrid = port_side(jcloud, jparams)
    key = jax.random.key(key_seed)
    noise = port_noise(jcfg, jgrid, tcloud, batch["raydir"].shape[1], key)
    jtc = jtrain.TrainConfig(**TRAIN)
    jstate = jtrain.create_train_state(jparams, jcloud, jtc)
    jstate, jl = jtrain.train_step(
        jstate, jgrid, jcfg, jtc,
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    with recording_cotangents([]) as seen:
        tstate, tl = ttrain.train_step(tstate, tgrid, tcfg,
                                       ttrain.TrainConfig(**TRAIN),
                                       torch_batch(batch), noise=noise)
    return jl, tl, jstate, tstate, seen


def check_step(jl, tl, jstate, tstate, seen, bf16=True):
    """Losses within 1e-5 and the MLPs within the Adam step's tolerance.
    The point gradients (Adam's first moments over 1 - b1) within 1e-5
    relative of the largest, or on a bf16 or int8 table within the bf16
    limit of the step's own cotangents; the trained point fields after
    Adam within its tolerance where the gradient's sign is sure (its
    magnitude above that limit), elsewhere within two steps (the first
    Adam step is lr * g / (|g| + eps): a sum that cancels to a few bf16
    ulps may land on either side of zero)."""
    assert set(jl) == set(tl), (sorted(jl), sorted(tl))
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-5, err_msg=k)
    jp = jax.tree.map(np.asarray, jstate.params)
    for block, layers in jp.items():
        for li, layer in enumerate(layers):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    tstate.params[block][li][k].numpy(), layer[k],
                    rtol=2e-3, atol=2e-6, err_msg=f"{block}.{li}.{k}")
    assert len(seen) == 1
    mu = optax.tree_utils.tree_get(jstate.opt_state_pts, "mu")
    tcfg = ttrain.TrainConfig(**TRAIN)
    fields = ttrain.trained_fields(tcfg)
    F = tstate.cloud.embedding.shape[-1]
    cols = {"embedding": slice(3, 3 + F), "color": slice(3 + F, 6 + F),
            "conf": slice(9 + F, 10 + F)}
    col_lim = tolerance(*seen[0], per_column=True)
    for f, m in zip(fields, tstate.opt_pts["m"]):
        jg = np.asarray(mu[f]) / 0.1
        lim = (float(col_lim[cols[f]].max()) if bf16
               else 1e-5 * float(np.abs(jg).max()))
        np.testing.assert_allclose(m.numpy() / 0.1, jg, rtol=0, atol=lim,
                                   err_msg=f)
        got = getattr(tstate.cloud, f).numpy()
        want = np.asarray(getattr(jstate.cloud, f))
        sure = np.abs(jg) > lim
        np.testing.assert_allclose(got[sure], want[sure], rtol=2e-3,
                                   atol=2e-6, err_msg=f)
        assert np.abs(got - want).max() <= 2 * tcfg.plr, f
