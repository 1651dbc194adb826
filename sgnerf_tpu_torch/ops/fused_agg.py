"""K2 and K3: the fused aggregator (PE -> block1 -> alpha -> K-reduction)
and its backward.

Counterpart of `sgnerf_tpu/ops/fused_agg.py: fused_block1_alpha` (forward
`_pallas_forward`, backward `_pallas_backward`). The CUDA kernels are
`csrc/fused_agg.cu` (K2) and `csrc/fused_agg_bwd.cu` (K3); their headers
say what bounds them and how they are laid out. `fused_block1_alpha_plain`
states the function in PyTorch and `fused_block1_alpha_bwd_plain` its
gradient (autograd of the plain version). The wrappers run the plain
versions only for tensors on the CPU; for CUDA tensors they launch the
kernels or raise. On CUDA `fused_block1_alpha` is a torch.autograd.Function
whose forward is K2 and whose backward is K3 (bwd="cuda") or the plain
gradient (bwd="plain", the JAX package's "xla" backward).

The kernels compute PE in the reference's interleaved layout against the
unpermuted block1 weights; the TPU kernels' frequency-major layout with
permuted W1 rows was a lane-layout device of that chip.

Derivatives follow JAX's conventions, so CPU autograd, the kernels and
the JAX package agree: leaky_relu' is 1 at exactly 0 (jnp.where(x >= 0)),
softplus' is sigmoid (0.5 at 0), and a bf16-mode product rounds its
cotangent and operands to bf16 in the backward too, as the reference's
`_dot_mm`/`dotT` do.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import _cuda
from .pe import positional_encoding


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0); its gradient is sigmoid(x)."""
    return torch.logaddexp(x, x.new_zeros(()))


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """jax.nn.leaky_relu: where(x >= 0, x, slope * x); slope 1 at 0."""
    return torch.where(x >= 0, x, slope * x)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _MatmulBF16(torch.autograd.Function):
    """x @ w with both inputs rounded to bf16 and an f32 result; the
    backward rounds the cotangent and the operands the same way."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = _bf16(x), _bf16(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _bf16(g)
        gx = gr @ wr.t()
        gw = (xr.reshape(-1, xr.shape[-1]).t()
              @ gr.reshape(-1, gr.shape[-1]))
        return gx, gw


def matmul(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x @ w in f32; with bf16, both inputs rounded to bf16 first (f32
    accumulation, like jnp.dot(..., preferred_element_type=f32))."""
    return _MatmulBF16.apply(x, w) if bf16 else x @ w


def fused_block1_alpha_plain(feat, d, w, block1: List[Dict[str, torch.Tensor]],
                             alpha_branch, *, K: int, nf: int, df: int,
                             bf16: bool):
    """Plain PyTorch K2: feat (M,K,F), d (M,K,Dd), w (M,K) ->
    (feat_agg (M,C), alpha (M,1))."""
    x = torch.cat([feat, positional_encoding(feat, nf),
                   positional_encoding(d, df)], dim=-1)
    h = x
    for layer in block1:
        h = leaky_relu(matmul(h, layer["w"], bf16) + layer["b"])
    wa, ba = alpha_branch[0]["w"], alpha_branch[0]["b"]
    alpha = softplus((h * wa[:, 0]).sum(-1, keepdim=True) + ba - 1.0)
    z = torch.cat([h * w[..., None], alpha * w[..., None]], dim=-1).sum(1)
    C = h.shape[-1]
    return z[:, :C], z[:, C:]


def fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha_branch, g, *,
                                 K: int, nf: int, df: int, bf16: bool):
    """Plain K3: the gradient of fused_block1_alpha_plain for the output
    cotangent g (M, C+1) = [gF | gA]. Returns (d_feat (M,K,F), d_d (M,K,Dd),
    d_w (M,K), d_block1 [{"w","b"}...], d_alpha [{"w","b"}])."""
    leaves = [feat, d, w] + [t for layer in block1 + alpha_branch
                             for t in (layer["w"], layer["b"])]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        n1 = 2 * len(block1)
        b1 = [{"w": leaves[3 + 2 * i], "b": leaves[4 + 2 * i]}
              for i in range(len(block1))]
        ab = [{"w": leaves[3 + n1], "b": leaves[4 + n1]}]
        fa, al = fused_block1_alpha_plain(leaves[0], leaves[1], leaves[2], b1,
                                          ab, K=K, nf=nf, df=df, bf16=bf16)
        C = fa.shape[-1]
        grads = torch.autograd.grad((fa, al), leaves,
                                    grad_outputs=(g[:, :C], g[:, C:]))
    return _unflatten_grads(grads, len(block1))


def _unflatten_grads(grads, n_layers):
    dfeat, dd, dw = grads[:3]
    rest = grads[3:]
    dblock1 = [{"w": rest[2 * i], "b": rest[2 * i + 1]}
               for i in range(n_layers)]
    dalpha = [{"w": rest[2 * n_layers], "b": rest[2 * n_layers + 1]}]
    return dfeat, dd, dw, dblock1, dalpha


def _check(feat, d, w, block1, alpha_branch, K):
    if feat.dim() != 3 or feat.shape[1] != K:
        raise ValueError(f"feat must be (M, K={K}, F), got {tuple(feat.shape)}")
    M = feat.shape[0]
    if d.dim() != 3 or d.shape[:2] != feat.shape[:2]:
        raise ValueError(f"d must be ({M}, {K}, Dd), got {tuple(d.shape)}")
    if tuple(w.shape) != (M, K):
        raise ValueError(f"w must be ({M}, {K}), got {tuple(w.shape)}")
    if len(alpha_branch) != 1:
        raise ValueError("the fused path needs a 1-layer alpha head")
    ts = [feat, d, w, alpha_branch[0]["w"], alpha_branch[0]["b"]] + \
        [t for layer in block1 for t in (layer["w"], layer["b"])]
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("fused_block1_alpha takes float32 tensors only")
    return ts


def _check_cuda(ts, feat, d, block1, K, nf, df, what, max_k=64, max_in=None):
    """Device and shape checks of a kernel launch; returns (C, in0)."""
    if feat.device.type != "cuda" or any(t.device != feat.device for t in ts):
        raise ValueError(f"{what}: every tensor must lie on one CUDA device "
                         "(or all on the CPU)")
    Fd, Dd = feat.shape[-1], d.shape[-1]
    C = block1[0]["w"].shape[1]
    in0 = Fd + 2 * Fd * nf + 2 * Dd * df
    if block1[0]["w"].shape[0] != in0 or any(
            tuple(l_["w"].shape) != (C, C) for l_ in block1[1:]):
        raise ValueError(f"block1 must be ({in0},{C}) then ({C},{C}) layers")
    if (C % 32 or not 32 <= C <= 256 or not 1 <= K <= max_k
            or (max_in is not None and in0 > max_in)):
        raise ValueError(f"{what} needs C % 32 == 0, C <= 256, K <= {max_k}"
                         f", block1 input <= {max_in}; got C={C} K={K} "
                         f"in={in0}")
    return C, in0


def _launch_fwd(feat, d, w, block1, alpha_branch, K, nf, df, bf16):
    ts = _check(feat, d, w, block1, alpha_branch, K)
    C, _ = _check_cuda(ts, feat, d, block1, K, nf, df, "fused_block1_alpha")
    M, _, Fd = feat.shape
    Dd = d.shape[-1]
    Wall = torch.cat([l_["w"].reshape(-1) for l_ in block1])
    Ball = torch.cat([l_["b"].reshape(-1) for l_ in block1])
    wa = alpha_branch[0]["w"].reshape(-1).contiguous()
    ba = alpha_branch[0]["b"].reshape(-1).contiguous()
    feat, d, w = feat.contiguous(), d.contiguous(), w.contiguous()
    out = torch.empty((M, C + 1), dtype=torch.float32, device=feat.device)
    lib = _cuda.load("fused_agg")
    with torch.cuda.device(feat.device):
        err = lib.fused_block1_alpha(
            _cuda.ptr(feat), _cuda.ptr(d), _cuda.ptr(w), _cuda.ptr(Wall),
            _cuda.ptr(Ball), len(block1), _cuda.ptr(wa), _cuda.ptr(ba),
            M, K, Fd, nf, Dd, df, C, int(bf16), _cuda.ptr(out),
            _cuda.stream_of(feat))
    fused_block1_alpha.launches += 1
    _cuda.check(lib, err, "fused_block1_alpha")
    return out


def fused_block1_alpha_bwd(feat, d, w, block1, alpha_branch, g, *, K: int,
                           nf: int, df: int, bf16: bool):
    """K3: the gradient of fused_block1_alpha for the cotangent g (M, C+1).
    Same returns as fused_block1_alpha_bwd_plain, which it runs for CPU
    tensors. `fused_block1_alpha_bwd.launches` counts kernel launches."""
    ts = _check(feat, d, w, block1, alpha_branch, K)
    if feat.device.type == "cpu":
        return fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha_branch,
                                            g, K=K, nf=nf, df=df, bf16=bf16)
    C, in0 = _check_cuda(ts + [g], feat, d, block1, K, nf, df,
                         "fused_block1_alpha_bwd", max_k=32, max_in=288)
    M, _, Fd = feat.shape
    Dd = d.shape[-1]
    L = len(block1)
    if tuple(g.shape) != (M, C + 1) or g.dtype != torch.float32:
        raise ValueError(f"g must be float32 ({M}, {C + 1}), got "
                         f"{g.dtype} {tuple(g.shape)}")
    Wall = torch.cat([l_["w"].reshape(-1) for l_ in block1])
    WTall = torch.cat([l_["w"].t().contiguous().reshape(-1) for l_ in block1])
    Ball = torch.cat([l_["b"].reshape(-1) for l_ in block1])
    wa = alpha_branch[0]["w"].reshape(-1).contiguous()
    ba = alpha_branch[0]["b"].reshape(-1).contiguous()
    feat, d, w, g = (t.detach().contiguous() for t in (feat, d, w, g))
    dev = feat.device
    S = in0 * C + (L - 1) * C * C + L * C + C + 1
    n_tiles = -(-M // (32 // K))          # tiles of 32 // K points
    n_blocks = min(n_tiles, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    partial = torch.empty((max(n_blocks, 1), S), dtype=torch.float32,
                          device=dev)
    dfeat = torch.empty_like(feat)
    dd = torch.empty_like(d)
    dw = torch.empty_like(w)
    dparams = torch.empty((S,), dtype=torch.float32, device=dev)
    lib = _cuda.load("fused_agg_bwd")
    with torch.cuda.device(dev):
        err = lib.fused_block1_alpha_bwd(
            _cuda.ptr(feat), _cuda.ptr(d), _cuda.ptr(w), _cuda.ptr(g),
            _cuda.ptr(Wall), _cuda.ptr(WTall), _cuda.ptr(Ball), L,
            _cuda.ptr(wa), _cuda.ptr(ba), M, K, Fd, nf, Dd, df, C, int(bf16),
            n_blocks, _cuda.ptr(partial), _cuda.ptr(dfeat), _cuda.ptr(dd),
            _cuda.ptr(dw), _cuda.ptr(dparams), _cuda.stream_of(feat))
    fused_block1_alpha_bwd.launches += 1
    _cuda.check(lib, err, "fused_block1_alpha_bwd")
    sizes = ([in0 * C] + [C * C] * (L - 1) + [C] * L + [C, 1])
    parts = torch.split(dparams, sizes)
    dblock1 = [{"w": parts[i].view(block1[i]["w"].shape),
                "b": parts[L + i].view(block1[i]["b"].shape)}
               for i in range(L)]
    dalpha = [{"w": parts[2 * L].view(alpha_branch[0]["w"].shape),
               "b": parts[2 * L + 1].view(alpha_branch[0]["b"].shape)}]
    return dfeat, dd, dw, dblock1, dalpha


class _FusedBlock1Alpha(torch.autograd.Function):
    """Forward K2; backward K3 (or the plain gradient, bwd="plain")."""

    @staticmethod
    def forward(ctx, meta, feat, d, w, *weights):
        K, nf, df, bf16, _ = meta
        block1, alpha_branch = _unflatten_weights(weights)
        ctx.meta = meta
        ctx.save_for_backward(feat, d, w, *weights)
        return _launch_fwd(feat, d, w, block1, alpha_branch, K, nf, df, bf16)

    @staticmethod
    def backward(ctx, g):
        feat, d, w, *weights = ctx.saved_tensors
        K, nf, df, bf16, bwd = ctx.meta
        block1, alpha_branch = _unflatten_weights(weights)
        fn = (fused_block1_alpha_bwd if bwd == "cuda"
              else fused_block1_alpha_bwd_plain)
        dfeat, dd, dw, dblock1, dalpha = fn(
            feat, d, w, block1, alpha_branch, g.contiguous(), K=K, nf=nf,
            df=df, bf16=bf16)
        return (None, dfeat, dd, dw,
                *[t for layer in dblock1 + dalpha
                  for t in (layer["w"], layer["b"])])


def _unflatten_weights(weights):
    n = (len(weights) - 2) // 2
    block1 = [{"w": weights[2 * i], "b": weights[2 * i + 1]} for i in range(n)]
    return block1, [{"w": weights[-2], "b": weights[-1]}]


def fused_block1_alpha(feat: torch.Tensor, d: torch.Tensor, w: torch.Tensor,
                       block1: List[Dict[str, torch.Tensor]],
                       alpha_branch: List[Dict[str, torch.Tensor]], *,
                       K: int, nf: int, df: int, bf16: bool,
                       bwd: str = "cuda"):
    """feat (M,K,F) f32, d (M,K,Dd), w (M,K) weight*conf (0 = masked) ->
    (feat_agg (M,C), alpha (M,1)). Differentiable; on CUDA the backward is
    K3 (bwd="cuda") or the plain gradient (bwd="plain").
    `fused_block1_alpha.launches` counts forward kernel launches."""
    _check(feat, d, w, block1, alpha_branch, K)
    if feat.device.type == "cpu":
        return fused_block1_alpha_plain(feat, d, w, block1, alpha_branch,
                                        K=K, nf=nf, df=df, bf16=bf16)
    if bwd not in ("cuda", "plain"):
        raise ValueError(f"bwd must be cuda or plain, got {bwd!r}")
    weights = [t for layer in block1 + alpha_branch
               for t in (layer["w"], layer["b"])]
    out = _FusedBlock1Alpha.apply((K, nf, df, bf16, bwd), feat, d, w,
                                  *weights)
    C = block1[0]["w"].shape[1]
    return out[:, :C], out[:, C:]


fused_block1_alpha.launches = 0
fused_block1_alpha_bwd.launches = 0
