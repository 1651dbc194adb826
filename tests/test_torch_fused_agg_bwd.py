"""Kernel K3's plain version (sgnerf_tpu_torch/ops/fused_agg.py
`fused_block1_alpha_bwd`, CPU tensors) vs the JAX package's fused backward
`_pallas_backward` (Pallas, interpret mode on the CPU) and vs jax.vjp of
its un-fused statement `_xla_ref`.

Tolerances: f32 rtol 2e-3, atol 2e-5, those of tests/test_fused_agg.py:150
(the two sides sum in different orders). bf16 rounds every product input;
a one-ulp difference before a cast flips that input's bf16 rounding
(2^-8 relative), so each gradient is held within 2e-2 of its largest
magnitude. M = 300 spans the JAX kernel's TM = 160 tiles plus padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.ops.fused_agg import _pallas_backward, _xla_ref
from sgnerf_tpu.ops.fused_agg import fused_block1_alpha as jax_fused
from sgnerf_tpu_torch.models.params import params_from_jax
from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                            fused_block1_alpha_bwd,
                                            fused_block1_alpha_bwd_plain)

K, NF, DF = 8, 3, 5


@pytest.fixture(scope="module")
def params():
    p = jagg.init_aggregator_params(jax.random.key(1), jagg.AggregatorConfig())
    return jax.tree.map(np.asarray, p)


def _inputs(seed, M=300, F=32, Dd=6, C=256):
    rng = np.random.default_rng(seed)
    feat = (rng.normal(size=(M, K, F)) * 0.2).astype(np.float32)
    d = (rng.normal(size=(M, K, Dd)) * 0.05).astype(np.float32)
    w = (rng.random((M, K)) * (rng.random((M, K)) < 0.7)).astype(np.float32)
    g = rng.normal(size=(M, C + 1)).astype(np.float32)
    return feat, d, w, g


def _port_grads(feat, d, w, params, g, bf16):
    tp = params_from_jax(params)
    out = fused_block1_alpha_bwd(
        torch.from_numpy(feat), torch.from_numpy(d), torch.from_numpy(w),
        tp["block1"], tp["alpha_branch"], torch.from_numpy(g),
        K=K, nf=NF, df=DF, bf16=bf16)
    dfeat, dd, dw, dblock1, dalpha = out
    return [dfeat, dd, dw] + [t for l_ in dblock1 + dalpha
                              for t in (l_["w"], l_["b"])]


def _flat_jax(grads):
    dfeat, dd, dw, dblock1, dalpha = grads
    return [dfeat, dd, dw] + [t for l_ in list(dblock1) + list(dalpha)
                              for t in (l_["w"], l_["b"])]


def _assert_close(got, ref, bf16):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if bf16:
            err = np.abs(a - b).max()
            assert err <= 2e-2 * np.abs(b).max() + 1e-6, (i, err)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5,
                                       err_msg=f"gradient {i}")


def _jax_args(feat, d, w, params):
    return (jnp.asarray(feat), jnp.asarray(d), jnp.asarray(w),
            params["block1"], params["alpha_branch"])


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_k3_matches_jax_pallas_backward(params, bf16):
    feat, d, w, g = _inputs(int(bf16))
    C = g.shape[1] - 1
    ref = _pallas_backward((K, NF, DF, bf16), *_jax_args(feat, d, w, params),
                           (jnp.asarray(g[:, :C]), jnp.asarray(g[:, C:])))
    _assert_close(_port_grads(feat, d, w, params, g, bf16), _flat_jax(ref),
                  bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_k3_matches_jax_vjp_of_xla_ref(params, bf16):
    feat, d, w, g = _inputs(2 + int(bf16))
    C = g.shape[1] - 1
    _, vjp = jax.vjp(lambda *a: _xla_ref((K, NF, DF, bf16), *a),
                     *_jax_args(feat, d, w, params))
    ref = vjp((jnp.asarray(g[:, :C]), jnp.asarray(g[:, C:])))
    _assert_close(_port_grads(feat, d, w, params, g, bf16), _flat_jax(ref),
                  bf16)


def test_plain_k3_leaky_relu_slope_at_zero(params):
    """Zero block1 weights and biases put every pre-activation at exactly
    0: JAX's leaky_relu passes the gradient with slope 1 there (PyTorch's
    F.leaky_relu would use 0.01)."""
    feat, d, w, g = _inputs(4, M=40)
    zero = {k: [{"w": np.zeros_like(l_["w"]), "b": np.zeros_like(l_["b"])}
                for l_ in v] if k == "block1" else v
            for k, v in params.items()}
    C = g.shape[1] - 1
    ref = _pallas_backward((K, NF, DF, False), *_jax_args(feat, d, w, zero),
                           (jnp.asarray(g[:, :C]), jnp.asarray(g[:, C:])))
    got = _port_grads(feat, d, w, zero, g, False)
    _assert_close(got, _flat_jax(ref), False)
    # slope 1: the last layer's bias gradient is the full sum of da
    assert np.abs(got[6].numpy()).max() > 1.0


def test_autograd_of_plain_k2_equals_plain_k3(params):
    """On the CPU, fused_block1_alpha is the plain forward and autograd
    differentiates it: the same gradients as the explicit plain K3."""
    feat, d, w, g = _inputs(5, M=33)
    tp = params_from_jax(params)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (feat, d, w)]
    fa, al = fused_block1_alpha(*leaves, tp["block1"], tp["alpha_branch"],
                                K=K, nf=NF, df=DF, bf16=False)
    C = fa.shape[-1]
    got = torch.autograd.grad((fa, al), leaves,
                              grad_outputs=(torch.from_numpy(g[:, :C]),
                                            torch.from_numpy(g[:, C:])))
    ref = fused_block1_alpha_bwd_plain(
        *(torch.from_numpy(a) for a in (feat, d, w)), tp["block1"],
        tp["alpha_branch"], torch.from_numpy(g), K=K, nf=NF, df=DF,
        bf16=False)
    for a, b in zip(got, ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_jax_forward_matches_for_the_same_inputs(params):
    """The backward's inputs are the forward's: hold the plain forward to
    the JAX kernel on this file's inputs too."""
    feat, d, w, _ = _inputs(6, M=50)
    fa, al = jax_fused(*_jax_args(feat, d, w, params), K=K, nf=NF, df=DF,
                       bf16=False)
    tp = params_from_jax(params)
    tfa, tal = fused_block1_alpha(
        torch.from_numpy(feat), torch.from_numpy(d), torch.from_numpy(w),
        tp["block1"], tp["alpha_branch"], K=K, nf=NF, df=DF, bf16=False)
    np.testing.assert_allclose(tfa.numpy(), np.asarray(fa), atol=3e-5)
    np.testing.assert_allclose(tal.numpy(), np.asarray(al), atol=3e-6)
