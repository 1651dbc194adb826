"""K2-K5: the fused aggregator (PE -> block1 -> alpha -> K-reduction), its
backward, and its variants with the colour head and the volume march.

Counterpart of `sgnerf_tpu/ops/fused_agg.py`: `fused_block1_alpha`
(forward `_pallas_forward`, backward `_pallas_backward`),
`fused_block1_alpha_color` and `fused_block1_alpha_color_march`. The CUDA
kernels are `csrc/fused_agg.cu` (K2), `csrc/fused_agg_bwd.cu` (K3, three
launches: K3a-K3c) and `csrc/fused_agg_color.cu` (K4, K5); their headers
say what bounds them and how they are laid out. Each `*_plain` function
states a kernel's function in PyTorch (K3's: one per launch, composed by
`fused_block1_alpha_bwd_plain`, which equals autograd of the plain
forward). The wrappers run the plain versions only for tensors on the CPU;
for CUDA tensors they launch the kernels or raise. `k2_supports`,
`k3_supports` and `k4_supports` (K5 with SR) state the shapes each kernel
takes, asking the CUDA library for the shared-memory clause on the card;
the aggregator's gate consults them. On CUDA `fused_block1_alpha` is a
torch.autograd.Function whose forward is K2 and whose backward is K3
(bwd="cuda") or the plain gradient (bwd="plain", the JAX package's "xla"
backward); `fused_block1_alpha_color` likewise has K4 forward and, with
bwd="cuda", the JAX package's "pallas" backward composed of K2, autograd of
the colour tail and K3 (`fused_block1_alpha_color_bwd`). K5 is eval only
and has no gradient.

The kernels compute PE in the reference's interleaved layout against the
unpermuted block1 weights; the TPU kernels' frequency-major layout with
permuted W1 rows was a lane-layout device of that chip. K2 runs block1's
products on the tensor cores (bf16, or 3xTF32 in f32 mode) from weights
`pack_block1` lays out for its shared-memory ring (bf16 k-slices, or tf32
hi/lo pairs; `tf32_rna` is the card's rounding), packed again only when
the weights change. K4 and K5 are two launches: K2's kernel writes the
reduced rows, then the colour head's kernel (`fused_color_head`, also
callable alone) runs the colour MLP on the tensor cores from weights
`pack_color` lays out the same way (`head_plan` its shapes) and, for K5,
the march.

Derivatives follow JAX's conventions, so CPU autograd, the kernels and
the JAX package agree: leaky_relu' is 1 at exactly 0 (jnp.where(x >= 0)),
softplus' is sigmoid (0.5 at 0), and a bf16-mode product rounds its
cotangent and operands to bf16 in the backward too, as the reference's
`_dot_mm`/`dotT` do.
"""
from __future__ import annotations

import math
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


def _flat(layers):
    return [t for layer in layers for t in (layer["w"], layer["b"])]


def _layers(flat, counts):
    """Flat (w, b, w, b, ...) -> one list of {"w","b"} layers per count."""
    out, i = [], 0
    for n in counts:
        out.append([{"w": flat[i + 2 * j], "b": flat[i + 2 * j + 1]}
                    for j in range(n)])
        i += 2 * n
    return out


def _vjp(fn, tensors, blocks, grad_outputs):
    """Gradients of fn(*tensors, *layer lists) for `grad_outputs`, by
    autograd on detached copies; returns (tensor grads, layer-list grads)."""
    counts = [len(b) for b in blocks]
    leaves = [t.detach().requires_grad_(True)
              for t in list(tensors) + [t for b in blocks for t in _flat(b)]]
    with torch.enable_grad():
        outs = fn(*leaves[:len(tensors)],
                  *_layers(leaves[len(tensors):], counts))
        grads = torch.autograd.grad(outs, leaves, grad_outputs=grad_outputs)
    return grads[:len(tensors)], _layers(grads[len(tensors):], counts)


# K3 runs as three launches over the N = M*K neighbour rows (csrc/
# fused_agg_bwd.cu): K3a recomputes the forward and saves what the
# backward reads, K3b runs the data-gradient chain, K3c forms the weight
# gradients. Their plain statements follow; fused_block1_alpha_bwd_plain
# composes them. Saved activations are the f32 values the products take
# as inputs (bf16 mode rounds them where it multiplies).


def k3a_recompute_plain(feat, d, block1, alpha_branch, *, nf: int, df: int,
                        bf16: bool):
    """Plain K3a: feat (M,K,F), d (M,K,Dd) -> (x (N, in0) the PE rows
    [feat | PE(feat) | PE(d)], hs (L, N, C) every layer's post-activation,
    raw (N,) = h^{L-1} . wa + ba)."""
    x = torch.cat([feat, positional_encoding(feat, nf),
                   positional_encoding(d, df)], dim=-1)
    x = x.reshape(-1, x.shape[-1])
    hs, h = [], x
    for layer in block1:
        h = leaky_relu(matmul(h, layer["w"], bf16) + layer["b"])
        hs.append(h)
    wa, ba = alpha_branch[0]["w"], alpha_branch[0]["b"]
    raw = (h * wa[:, 0]).sum(-1) + ba
    return x, torch.stack(hs), raw


def pe_fold(dx, x, F: int, Dd: int, nf: int, df: int):
    """The PE chain rule: dx (N, in0), the cotangent of the PE rows x (N,
    in0) -> (d_feat (N, F), d_d (N, Dd)): per channel, its raw column plus
    sum_f 2^f (d sin . cos - d cos . sin)."""
    def fold(lo, n, nfr):
        span = slice(lo, lo + 2 * n * nfr)
        g = dx[:, span].reshape(-1, n, nfr, 2)
        v = x[:, span].reshape(-1, n, nfr, 2)
        dz = g[..., 0] * v[..., 1] - g[..., 1] * v[..., 0]
        bands = 2.0 ** torch.arange(nfr, dtype=dx.dtype, device=dx.device)
        return (dz * bands).sum(-1)
    dfeat = dx[:, :F] + fold(F, F, nf)
    return dfeat, fold(F + 2 * F * nf, Dd, df)


def k3b_data_grads_plain(x, hs, raw, w, g, block1, alpha_branch, *, K: int,
                         nf: int, df: int, F: int, bf16: bool):
    """Plain K3b: K3a's outputs, w (M,K) and the cotangent g (M, C+1) =
    [gF | gA] -> (d_feat (N, F), d_d (N, Dd), d_w (N,), dhs (L, N, C) the
    cotangent of every layer's pre-activation, alpha_part (T, C+1) partial
    sums of [d_wa | d_ba] that K3c adds up; T = 1 here)."""
    C = g.shape[-1] - 1
    gF = g[:, :C].repeat_interleave(K, dim=0)
    gA = g[:, C].repeat_interleave(K)
    wr = w.reshape(-1)
    h = hs[-1]
    xa = raw - 1.0
    d_w = (gF * h).sum(-1) + softplus(xa) * gA
    # softplus' = sigmoid, in autograd's form (the same bits)
    draw = (gA * wr) / (1.0 + torch.exp(-xa))
    da = gF * wr[:, None] + draw[:, None] * alpha_branch[0]["w"][:, 0]
    dhs = [None] * len(block1)
    for l in reversed(range(len(block1))):
        dhs[l] = torch.where(hs[l] >= 0, da, 0.01 * da)
        da = matmul(dhs[l], block1[l]["w"].t(), bf16)
    Dd = (x.shape[-1] - F - 2 * F * nf) // (2 * df)
    dfeat, dd = pe_fold(da, x, F, Dd, nf, df)
    alpha_part = torch.cat([(h * draw[:, None]).sum(0), draw.sum()[None]])
    return dfeat, dd, d_w, torch.stack(dhs), alpha_part[None]


def k3c_weight_grads_plain(x, hs, dhs, alpha_part, *, bf16: bool):
    """Plain K3c: -> the flat weight gradient (params_grad_size): dW_0 =
    x^T dh^0, dW_l = h^{l-1 T} dh^l, db_l = sum dh^l, then [d_wa | d_ba]
    = the sum of alpha_part's rows. bf16 rounds the products' operands."""
    ins = [x] + list(hs[:-1])
    dW = [matmul(a.t(), b, bf16) for a, b in zip(ins, dhs)]
    db = [b.sum(0) for b in dhs]
    return torch.cat([t.reshape(-1) for t in dW + db]
                     + [alpha_part.sum(0)])


def params_grad_size(n_layers: int, in0: int, C: int) -> int:
    """Floats of K3's flat weight gradient: dW_0 (in0 x C) | dW_1..
    (C x C) | db_0.. (C each) | d_wa (C) | d_ba (1)."""
    return in0 * C + (n_layers - 1) * C * C + n_layers * C + C + 1


def _split_params_grad(flat, block1, alpha_branch):
    """K3's flat weight gradient -> (d_block1, d_alpha) layer lists."""
    L = len(block1)
    in0, C = block1[0]["w"].shape
    parts = torch.split(flat, [in0 * C] + [C * C] * (L - 1) + [C] * L
                        + [C, 1])
    dblock1 = [{"w": parts[i].view(block1[i]["w"].shape),
                "b": parts[L + i].view(block1[i]["b"].shape)}
               for i in range(L)]
    dalpha = [{"w": parts[2 * L].view(alpha_branch[0]["w"].shape),
               "b": parts[2 * L + 1].view(alpha_branch[0]["b"].shape)}]
    return dblock1, dalpha


def fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha_branch, g, *,
                                 K: int, nf: int, df: int, bf16: bool,
                                 branches=None):
    """Plain K3: K3a, K3b and K3c's plain statements in turn; the gradient
    of fused_block1_alpha_plain for the output cotangent g (M, C+1) =
    [gF | gA]. Returns (d_feat (M,K,F), d_d (M,K,Dd), d_w (M,K), d_block1
    [{"w","b"}...], d_alpha [{"w","b"}]).

    K3 is the gradient of the forward that ran: K3a recomputes K2's
    activations bit for bit and reads LeakyReLU's branch from them.
    `branches` (L, N, C), optional, are such activations (K3a's); where
    the plain recompute's activation lies on the other branch (a
    pre-activation within the two forwards' rounding of zero), the plain
    K3 takes that activation's value and branch from them."""
    F = feat.shape[-1]
    x, hs, raw = k3a_recompute_plain(feat, d, block1, alpha_branch, nf=nf,
                                     df=df, bf16=bf16)
    if branches is not None:
        hs = torch.where((hs >= 0) == (branches >= 0), hs,
                         branches.to(hs.dtype))
    dfeat, dd, dw, dhs, alpha_part = k3b_data_grads_plain(
        x, hs, raw, w, g, block1, alpha_branch, K=K, nf=nf, df=df, F=F,
        bf16=bf16)
    flat = k3c_weight_grads_plain(x, hs, dhs, alpha_part, bf16=bf16)
    dblock1, dalpha = _split_params_grad(flat, block1, alpha_branch)
    return (dfeat.view(feat.shape), dd.view(d.shape), dw.view(w.shape),
            dblock1, dalpha)


def color_tail_plain(fa, vd, color_branch, *, vf: int, bf16: bool):
    """The colour head on the K-reduced features (the JAX package's
    `_xla_color_tail`): [fa | PE(vd) without the raw directions] -> MLP,
    LeakyReLU between layers, raw logits out. fa (M,C), vd (M,3)."""
    x = torch.cat([fa, positional_encoding(vd, vf, ori=True)[..., 3:]], -1)
    for i, layer in enumerate(color_branch):
        x = matmul(x, layer["w"], bf16) + layer["b"]
        if i < len(color_branch) - 1:
            x = leaky_relu(x)
    return x


def fused_block1_alpha_color_plain(feat, d, w, vd, block1, alpha_branch,
                                   color_branch, *, K: int, nf: int, df: int,
                                   vf: int, bf16: bool):
    """Plain K4 (the JAX package's `_xla_ref_color`): K2, then the colour
    head on the reduced features -> (alpha (M,1), raw_color (M,3))."""
    fa, al = fused_block1_alpha_plain(feat, d, w, block1, alpha_branch, K=K,
                                      nf=nf, df=df, bf16=bf16)
    return al, color_tail_plain(fa, vd, color_branch, vf=vf, bf16=bf16)


def fused_block1_alpha_color_bwd_plain(feat, d, w, vd, block1, alpha_branch,
                                       color_branch, g, *, K: int, nf: int,
                                       df: int, vf: int, bf16: bool):
    """The gradient of fused_block1_alpha_color_plain for the cotangent g
    (M, 4) = [g_alpha | g_rgb], by autograd. Returns (d_feat, d_d, d_w, d_vd,
    d_block1, d_alpha, d_color)."""
    (dfeat, dd, dw, dvd), (dblock1, dalpha, dcolor) = _vjp(
        lambda *a: fused_block1_alpha_color_plain(
            *a, K=K, nf=nf, df=df, vf=vf, bf16=bf16),
        (feat, d, w, vd), (block1, alpha_branch, color_branch),
        (g[:, 0:1], g[:, 1:4]))
    return dfeat, dd, dw, dvd, dblock1, dalpha, dcolor


def fused_block1_alpha_color_march_plain(feat, d, w, vd, ray_dist, ray_valid,
                                         block1, alpha_branch, color_branch,
                                         *, K: int, nf: int, df: int, vf: int,
                                         SR: int, bf16: bool):
    """Plain K5: K4, then raw2out_color with act_super, opacity
    1 - exp(-alpha * ray_valid * ray_dist), the exclusive transmission as a
    sequential product over each ray's SR points, and the alpha blend.
    ray_dist, ray_valid (M,) f32 -> (M/SR, 4) [ray colour | background
    transmission]."""
    al, hc = fused_block1_alpha_color_plain(
        feat, d, w, vd, block1, alpha_branch, color_branch, K=K, nf=nf,
        df=df, vf=vf, bf16=bf16)
    return march_tail_plain(al, hc, ray_dist, ray_valid, SR=SR)


def march_tail_plain(al, hc, ray_dist, ray_valid, *, SR: int):
    """K5's march on K4's outputs: alpha (M,1), raw colour logits (M,3),
    ray_dist, ray_valid (M,) -> (M/SR, 4) [ray colour | background
    transmission]."""
    rgb = torch.sigmoid(hc) * (1.0 + 2 * 0.001) - 0.001
    op = 1.0 - torch.exp(-(al[:, 0] * ray_valid) * ray_dist)
    a = (1.0 - op + 1e-10).reshape(-1, SR)
    T = [torch.ones_like(a[:, 0])]
    for s in range(SR - 1):
        T.append(T[-1] * a[:, s])
    T = torch.stack(T, dim=1)
    ws = op.reshape(-1, SR) * T
    color = (ws[..., None] * rgb.reshape(-1, SR, 3)).sum(1)
    return torch.cat([color, T[:, -1:] * a[:, -1:]], dim=-1)


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
    in0 = Fd + 2 * Fd * nf + 2 * Dd * df
    return _check_block1(block1, in0, what, K, max_k, max_in), in0


def _check_block1(block1, in0, what, K=1, max_k=64, max_in=None):
    """Shapes the kernels take: block1 (in0, C) then (C, C) layers, C % 32
    == 0, C <= 256, 1 <= K <= max_k (None: no limit); returns C."""
    C = block1[0]["w"].shape[1]
    if block1[0]["w"].shape[0] != in0 or any(
            tuple(l_["w"].shape) != (C, C) for l_ in block1[1:]):
        raise ValueError(f"block1 must be ({in0},{C}) then ({C},{C}) layers")
    if (C % 32 or not 32 <= C <= 256 or K < 1
            or (max_k is not None and K > max_k)
            or (max_in is not None and in0 > max_in)):
        raise ValueError(f"{what} needs C % 32 == 0, C <= 256, K <= {max_k}"
                         f", block1 input <= {max_in}; got C={C} K={K} "
                         f"in={in0}")
    return C


def _check_color(M, vd, C, color_branch, vf, extra=()):
    """Shapes and types of K4/K5's extra inputs (M points, feature width
    C); returns their tensors and the colour head's hidden width."""
    if vd.dtype != torch.float32 or tuple(vd.shape) != (M, 3):
        raise ValueError(f"vd must be ({M}, 3) float32, got {vd.dtype} "
                         f"{tuple(vd.shape)}")
    if vf < 1:
        raise ValueError("the fused colour head needs PE'd view directions "
                         f"(vf >= 1), got vf={vf}")
    shapes = [tuple(l_["w"].shape) for l_ in color_branch]
    n = len(shapes)
    Nh = shapes[0][1] if n > 1 else 3
    want = ([(C + 6 * vf, Nh)] + [(Nh, Nh)] * (n - 2) + [(Nh, 3)] if n > 1
            else [(C + 6 * vf, 3)])
    if shapes != want:
        raise ValueError(f"color_branch must be {want}, got {shapes}")
    ts = [vd] + list(extra) + _flat(color_branch)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("the fused colour kernels take float32 tensors only")
    return ts, Nh


# The tile body's weight layout (csrc/fused_agg_body.cuh): per layer,
# k-slices of SLICE_DEPTH input rows, each WGMMA_N output columns wide (the
# columns past C zero) and made of 16-byte planes, each plane the 16 bytes
# of every column in turn (wgmma's no-swizzle K-major layout). bf16: four
# planes of 8 rows. f32: the tf32 hi planes of rows 0-3 and 4-7, then the
# lo planes.
SLICE_DEPTH = {True: 32, False: 8}
WGMMA_N = 256
TILE_ROWS = {True: 128, False: 64}   # rows of a tile: bf16, f32 mode
K3_MAX_IN = WGMMA_N + 32             # K3b's dx: 256 columns, then 32
K3C_SLAB = 2048                      # rows K3c sums into one partial
# The colour head's kernel (csrc/fused_agg_color.cu): tiles of 128 points
# (64 for an f32 head wider than 128), hidden layers padded to 64 columns,
# the 3-logit layer to 8
HEAD_TILE, HEAD_MAX_NH, HEAD_LAST_N = 128, 256, 8
# The bf16 colour head's hidden values, the kernel's against the plain
# head's (color_tail_on_roundings): the tensor cores' f32 sums round toward
# zero (PERF.md F9), within 2 units of n 2^-24 sum_k |x_k w_k| (n exact
# products) of the exact sum, cuBLAS's to nearest within 1 unit, so the two
# lie FLIP_BOUND units apart at most (sum_error_units measures either on
# the card). A flip is rare: at most FLIP_SHARE of a layer's values (1-2e-4
# on an eval chunk), or FLIP_FLOOR of a small layer's
FLIP_BOUND, FLIP_SHARE, FLIP_FLOOR = 3.0, 1e-3, 4


def _smem_fits(device, fn, *dims) -> bool:
    """Whether a block of the kernel fits the card's shared memory at these
    widths, as the CUDA library lays it out (`fused_block1_alpha_smem` or
    `fused_block1_alpha_color_smem`, host arithmetic). Off the card the
    plain versions run, which take any shape: True."""
    if device is None or torch.device(device).type != "cuda":
        return True
    lib = _cuda.load("fused_agg" if fn == "fused_block1_alpha_smem"
                     else "fused_agg_color")
    return getattr(lib, fn)(*dims) > 0


def k2_supports(*, K, F, Dd, nf, df, C, bf16, device=None):
    """The shapes K2 takes: C % 32 == 0, 32 <= C <= 256, 1 <= K <= 64,
    1 <= nf, df <= 30 and, on a CUDA `device`, its block within the card's
    shared memory."""
    return (C % 32 == 0 and 32 <= C <= 256 and 1 <= K <= 64 and F >= 1
            and Dd >= 1 and 1 <= nf <= 30 and 1 <= df <= 30
            and _smem_fits(device, "fused_block1_alpha_smem", F, nf, Dd, df,
                           C, int(bf16)))


def k3_supports(*, K, F, Dd, nf, df, C, bf16, device=None):
    """The shapes K3 takes: K2's widths (K3a is K2's body), any K, and a
    block1 input of at most K3_MAX_IN columns."""
    return (k2_supports(K=1, F=F, Dd=Dd, nf=nf, df=df, C=C, bf16=bf16,
                        device=device)
            and K >= 1 and F + 2 * F * nf + 2 * Dd * df <= K3_MAX_IN)


def k4_supports(*, K, F, Dd, nf, df, C, bf16, vf, Nh, n_clayers, SR=0,
                device=None):
    """The shapes K4 (or with SR > 0, K5) takes: K2's (K4 and K5 run K2's
    kernel, then the colour head on its rows), a colour head of n_clayers
    layers with 3 <= Nh <= 256 and 1 <= vf <= 30, and, on a CUDA `device`,
    K2's block and the head's within the card's shared memory."""
    return (k2_supports(K=K, F=F, Dd=Dd, nf=nf, df=df, C=C, bf16=bf16,
                        device=device)
            and n_clayers >= 1 and 1 <= vf <= 30
            and (n_clayers == 1 or 3 <= Nh <= HEAD_MAX_NH)
            and _smem_fits(device, "fused_block1_alpha_color_smem", K, F,
                           nf, Dd, df, C, vf, n_clayers, Nh, SR, int(bf16)))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as the card's cvt.rna.tf32.f32: the low 13 bits zero."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def pack_kslices(w: torch.Tensor, bf16: bool, width: int = WGMMA_N,
                 depth: int = None) -> torch.Tensor:
    """One (k, n <= width) operand B of the tile body's (or the colour
    head's) products in its layout, flat: the rows padded with zero rows to
    `depth` (default: a multiple of SLICE_DEPTH[bf16]), the columns with
    zeros to `width`, cut into k-slices of 16-byte planes (bf16, or tf32
    hi planes then lo planes)."""
    ks = SLICE_DEPTH[bf16]
    w = w.detach().to(torch.float32)
    k, n = w.shape
    kp = -(-k // ks) * ks if depth is None else depth
    if kp % ks or kp < k or n > width:
        raise ValueError(f"cannot pack ({k}, {n}) into depth {kp}, width "
                         f"{width}")
    wp = w.new_zeros(kp, width)
    wp[:k, :n] = w
    ws = wp.reshape(kp // ks, ks, width)            # (S, ks, N)
    if bf16:
        x = ws.reshape(-1, 4, 8, width).to(torch.bfloat16)
    else:
        hi = tf32_rna(ws)
        x = torch.cat([hi, tf32_rna(ws - hi)], 1).reshape(-1, 4, 4, width)
    return x.transpose(2, 3).reshape(-1)            # (S, plane, N, e)


def pack_block1(block1: List[Dict[str, torch.Tensor]], in0: int,
                bf16: bool):
    """block1's weights in the tile body's layout for one mode, and its
    biases: -> (packed weights, bf16 (bf16 mode) or float32 (tf32 hi/lo),
    flat; biases (n_layers * C,) float32). The first layer's in0 rows are
    padded with zero rows to a multiple of SLICE_DEPTH[bf16], the columns
    with zeros to WGMMA_N."""
    _check_block1(block1, in0, "pack_block1")
    packed = torch.cat([pack_kslices(l_["w"], bf16) for l_ in block1])
    bias = torch.cat([l_["b"].detach().reshape(-1) for l_ in block1])
    return packed, bias.to(torch.float32).contiguous()


def pack_block1_bwd(block1: List[Dict[str, torch.Tensor]], in0: int,
                    bf16: bool) -> torch.Tensor:
    """The B operands of K3b's products in the order it takes them, each
    packed by pack_kslices: W_{L-1}^T .. W_1^T (C x C), then W_0^T (C x
    in0) as its columns past WGMMA_N (when in0 > WGMMA_N) and its first
    WGMMA_N columns."""
    _check_block1(block1, in0, "pack_block1_bwd", max_in=K3_MAX_IN)
    w0t = block1[0]["w"].t()
    mats = [l_["w"].t() for l_ in reversed(block1[1:])]
    if in0 > WGMMA_N:
        mats.append(w0t[:, WGMMA_N:])
    mats.append(w0t[:, :WGMMA_N])
    return torch.cat([pack_kslices(m, bf16) for m in mats])


def head_plan(C: int, vf: int, Nh: int, n_clayers: int, bf16: bool):
    """The colour head kernel's shapes (csrc/fused_agg_color.cu
    `head_plan`): kp0, layer 0's depth C + 6 vf padded to the slice depth;
    Np, the hidden width padded to 64 columns (an f32 head wider than 128:
    256, its tile split between the warpgroups by columns); rows, the
    points a tile; the layers' padded (depth, width)."""
    ks = SLICE_DEPTH[bf16]
    kp0 = -(-(C + 6 * vf) // ks) * ks
    Np = -(-Nh // 64) * 64 if n_clayers > 1 else 0
    split = not bf16 and Np > 128
    if split:
        Np = HEAD_MAX_NH
    dims = [(kp0 if l_ == 0 else Np,
             HEAD_LAST_N if l_ == n_clayers - 1 else Np)
            for l_ in range(n_clayers)]
    return dict(kp0=kp0, Np=Np, split=split,
                rows=HEAD_TILE // 2 if split else HEAD_TILE, dims=dims)


def pack_color(color_branch: List[Dict[str, torch.Tensor]], vf: int,
               bf16: bool):
    """The colour head's weights in its kernel's layout for one mode, and
    its biases: each layer by pack_kslices at its padded (depth, width)
    from head_plan (zero rows and columns in the padding), concatenated;
    the biases padded with zeros to each width -> (packed weights, bf16 or
    float32 (tf32 hi/lo), flat; biases float32, flat). The first layer
    takes C + 6 vf inputs."""
    shapes = [tuple(l_["w"].shape) for l_ in color_branch]
    n = len(shapes)
    C = shapes[0][0] - 6 * vf
    Nh = shapes[0][1] if n > 1 else 3
    want = ([(C + 6 * vf, Nh)] + [(Nh, Nh)] * (n - 2) + [(Nh, 3)] if n > 1
            else [(C + 6 * vf, 3)])
    if shapes != want or (n > 1 and not 3 <= Nh <= HEAD_MAX_NH):
        raise ValueError(f"color_branch must be {want}, got {shapes}")
    plan = head_plan(C, vf, Nh, n, bf16)
    packed = torch.cat([pack_kslices(l_["w"], bf16, width=wd, depth=dp)
                        for l_, (dp, wd) in zip(color_branch, plan["dims"])])
    bias = torch.cat([torch.nn.functional.pad(
        l_["b"].detach().reshape(-1).to(torch.float32),
        (0, wd - l_["b"].numel()))
        for l_, (_, wd) in zip(color_branch, plan["dims"])])
    return packed, bias.contiguous()


_PACKED: dict = {}   # (kind, bf16) -> (weight tensors, versions, packed)


def _packed(fn, block1, in0, bf16):
    """fn(block1, in0, bf16) (pack_block1, pack_block1_bwd or pack_color),
    kept while the same weight tensors hold the same values (the same
    objects at the same version counts): the render calls K2 once a chunk
    with unchanged weights; an optimizer step bumps the versions. Inference
    tensors keep no version count and are packed every call."""
    ts = tuple(t for l_ in block1 for t in (l_["w"], l_["b"]))
    if any(t.is_inference() for t in ts):
        return fn(block1, in0, bf16)
    versions = tuple(t._version for t in ts)
    hit = _PACKED.get((fn.__name__, bf16))
    if (hit is not None and len(hit[0]) == len(ts)
            and all(a is b for a, b in zip(hit[0], ts))
            and hit[1] == versions):
        return hit[2]
    packed = fn(block1, in0, bf16)
    _PACKED[(fn.__name__, bf16)] = (ts, versions, packed)
    return packed


def _packed_block1(block1, in0, bf16):
    return _packed(pack_block1, block1, in0, bf16)


def _alpha_args(alpha_branch):
    return (alpha_branch[0]["w"].reshape(-1).contiguous(),
            alpha_branch[0]["b"].reshape(-1).contiguous())


def fused_block1_alpha_resources(F: int, nf: int, Dd: int, df: int, C: int,
                                 bf16: bool, device=None) -> Dict[str, int]:
    """K2's registers a thread, shared memory a block (bytes) and resident
    blocks an SM on the card, for feat width F, dist width Dd, PE
    frequencies nf, df and width C."""
    import ctypes
    lib = _cuda.load("fused_agg")
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.fused_block1_alpha_occupancy(
            F, nf, Dd, df, C, int(bf16), *(ctypes.byref(v) for v in vals))
    _cuda.check(lib, err, "fused_block1_alpha_occupancy")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _launch_fwd(feat, d, w, block1, alpha_branch, K, nf, df, bf16,
                count=True):
    """K2's launch -> (M, C+1); counted under fused_block1_alpha unless it
    is K4's or K5's first launch (count=False)."""
    ts = _check(feat, d, w, block1, alpha_branch, K)
    C, in0 = _check_cuda(ts, feat, d, block1, K, nf, df,
                         "fused_block1_alpha")
    M, _, Fd = feat.shape
    Dd = d.shape[-1]
    if not k2_supports(K=K, F=Fd, Dd=Dd, nf=nf, df=df, C=C, bf16=bf16,
                       device=feat.device):
        raise ValueError(f"fused_block1_alpha does not take K={K} F={Fd} "
                         f"Dd={Dd} nf={nf} df={df} C={C} (k2_supports)")
    Wall, Ball = _packed_block1(block1, in0, bf16)
    wa, ba = _alpha_args(alpha_branch)
    feat, d, w = (t.detach().contiguous() for t in (feat, d, w))
    out = torch.empty((M, C + 1), dtype=torch.float32, device=feat.device)
    lib = _cuda.load("fused_agg")
    with torch.cuda.device(feat.device):
        err = lib.fused_block1_alpha(
            _cuda.ptr(feat), _cuda.ptr(d), _cuda.ptr(w), _cuda.ptr(Wall),
            _cuda.ptr(Ball), len(block1), _cuda.ptr(wa), _cuda.ptr(ba),
            M, K, Fd, nf, Dd, df, C, int(bf16), _cuda.ptr(out),
            _cuda.stream_of(feat))
    if count:
        fused_block1_alpha.launches += 1
    _cuda.check(lib, err, "fused_block1_alpha")
    return out


def color_head_plain(red, vd, color_branch, *, vf: int, bf16: bool,
                     march=None):
    """Plain colour-head launch: on K2's reduced rows red (M, C+1) =
    [fa | alpha] and vd (M, 3) -> (M, 4) [alpha | raw colour logits]
    (color_tail_plain), or with march = (ray_dist, ray_valid, SR) the
    (M/SR, 4) [ray colour | background transmission] (march_tail_plain)."""
    C = red.shape[-1] - 1
    hc = color_tail_plain(red[:, :C], vd, color_branch, vf=vf, bf16=bf16)
    if march is None:
        return torch.cat([red[:, C:], hc], dim=-1)
    ray_dist, ray_valid, SR = march
    return march_tail_plain(red[:, C:], hc, ray_dist, ray_valid, SR=SR)


def _launch_head(red, vd, color_branch, vf, bf16, march=None, hid=None):
    """The colour head's launch on red (M, C+1) (K2's rows); hid, where
    given, (n_clayers - 1, M, Np) f32 takes its hidden activations."""
    M, C = red.shape[0], red.shape[1] - 1
    n = len(color_branch)
    Nh = color_branch[0]["w"].shape[1] if n > 1 else 3
    Wc, Bc = _packed(pack_color, color_branch, vf, bf16)
    red, vd = red.detach().contiguous(), vd.detach().contiguous()
    SR, rd, rv = 0, None, None
    if march is not None:
        rd, rv, SR = march
        rd, rv = rd.detach().contiguous(), rv.detach().contiguous()
    out = torch.empty((M // SR if SR else M, 4), dtype=torch.float32,
                      device=red.device)
    lib = _cuda.load("fused_agg_color")
    with torch.cuda.device(red.device):
        err = lib.fused_color_head(
            _cuda.ptr(red), _cuda.ptr(vd), _cuda.ptr(Wc), _cuda.ptr(Bc), n,
            Nh, M, C, vf, None if rd is None else _cuda.ptr(rd),
            None if rv is None else _cuda.ptr(rv), SR, int(bf16),
            _cuda.ptr(out), None if hid is None else _cuda.ptr(hid),
            _cuda.stream_of(red))
    _cuda.check(lib, err, "fused_color_head")
    return out


def fused_color_head(red, vd, color_branch, *, vf: int, bf16: bool,
                     march=None):
    """The colour head's kernel alone, K4's and K5's second launch: red
    (M, C+1) f32, K2's reduced rows, vd (M, 3) -> color_head_plain's
    output, which it runs for CPU tensors. Eval only (no gradient).
    `fused_color_head.launches` counts its launches made alone (K4's and
    K5's count under their own names)."""
    M = red.shape[0]
    if red.dim() != 2 or red.dtype != torch.float32:
        raise ValueError(f"red must be (M, C+1) float32, got {red.dtype} "
                         f"{tuple(red.shape)}")
    if march is not None:
        SR = march[2]
        if SR < 1 or M % SR:
            raise ValueError(f"M = {M} must be a multiple of SR = {SR}")
    C = red.shape[1] - 1
    ts, Nh = _check_color(M, vd, C, color_branch, vf,
                          () if march is None else march[:2])
    if red.device.type == "cpu":
        return color_head_plain(red, vd, color_branch, vf=vf, bf16=bf16,
                                march=march)
    if any(t.device != red.device for t in ts) or red.device.type != "cuda":
        raise ValueError("fused_color_head: every tensor must lie on one "
                         "CUDA device (or all on the CPU)")
    n = len(color_branch)
    if _cuda.load("fused_agg_color").fused_color_head_smem(
            C, vf, n, Nh, int(bf16)) == 0:
        raise ValueError(f"fused_color_head does not take C={C} vf={vf} "
                         f"Nh={Nh} n_clayers={n} (k4_supports)")
    out = _launch_head(red, vd, color_branch, vf, bf16, march)
    fused_color_head.launches += 1
    return out


def color_head_hidden(red, vd, color_branch, *, vf: int, bf16: bool):
    """The colour launch (CUDA tensors) with its hidden activations saved,
    for checks (chip_smoke.py phase 12, the card tests); not counted. ->
    (its (M, 4) output, (n_clayers - 1, M, Nh) the value of each hidden
    layer as the next layer multiplies it: bf16 mode rounded)."""
    M, C = red.shape[0], red.shape[1] - 1
    _check_color(M, vd, C, color_branch, vf)
    n = len(color_branch)
    Nh = color_branch[0]["w"].shape[1] if n > 1 else 3
    Np = head_plan(C, vf, Nh, n, bf16)["Np"]
    hid = torch.zeros((max(n - 1, 0), M, Np), dtype=torch.float32,
                      device=red.device)
    out = _launch_head(red, vd, color_branch, vf, bf16, hid=hid)
    return out, hid[..., :Nh]


def _bf16_preimage(v: torch.Tensor):
    """The f32 values that round (to nearest) to the bf16 values v: the
    interval between the midpoints to v's bf16 neighbours -> (lo, hi)."""
    bits = v.contiguous().view(torch.int32)
    step = torch.where(v == 0, v.new_zeros(()).view(torch.int32) + 0x10000,
                       bits + 0x10000).view(torch.float32)  # away from 0
    back = torch.where(v == 0, -step,
                       (bits - 0x10000).view(torch.float32))
    a, b = (v + step) / 2, (v + back) / 2
    return torch.minimum(a, b), torch.maximum(a, b)


def _z_preimage(h: torch.Tensor):
    """The pre-activations z whose LeakyReLU rounds (to nearest) to the bf16
    values h -> (lo, hi)."""
    return tuple(torch.where(t >= 0, t, t / 0.01) for t in _bf16_preimage(h))


def color_tail_on_roundings(fa, vd, color_branch, hidden, *, vf: int,
                            flip_bound: float = FLIP_BOUND):
    """The plain bf16 colour head (color_tail_plain with bf16) that takes,
    at each hidden layer, the kernel's bf16 value where its own rounding
    differs (a flip): the kernel's f32 sums are the tensor cores', the
    plain's cuBLAS's, and a value within their difference of a bf16
    midpoint (or of LeakyReLU's kink at 0) rounds either way. hidden
    (L-1, M, Nh): the kernel's (color_head_hidden). Distances count in
    units of n 2^-24 sum_k |x_k w_k|, the f32 sum's error bound for n
    terms. Raises ValueError unless every hidden value is a bf16 value, at
    most FLIP_SHARE of a layer's values flip (FLIP_FLOOR of a small
    layer's), and each flip's plain pre-activation z lies within flip_bound
    units of the values (in z) that round to the kernel's. That distance is
    also the check of adjacency: bf16 steps (in z) grow with |z| on each
    side of LeakyReLU's kink, so where flip_bound units are less than the
    steps of both values, a value between them would put z a step away,
    and the kernel's value must be the plain one's neighbour; across the
    kink, at zero, and where the sum cancels, the steps are finer than the
    sums' error and the distance alone bounds the flip. -> (logits (M, 3),
    flips a layer, the largest distance of a flip, in units)."""
    if not torch.equal(_bf16(hidden), hidden):
        raise ValueError("hidden values that are not bf16 values (or not "
                         "finite): the kernel did not round them")
    x = torch.cat([fa, positional_encoding(vd, vf, ori=True)[..., 3:]], -1)
    flips, worst = [], 0.0
    for i, (layer, hk) in enumerate(zip(color_branch[:-1], hidden)):
        xr, wr = _bf16(x), _bf16(layer["w"])
        z = xr @ wr + layer["b"]
        h = leaky_relu(z)
        hp = _bf16(h)
        flip = hp != hk
        flips.append(int(flip.sum()))
        cap = max(math.ceil(FLIP_SHARE * flip.numel()), FLIP_FLOOR)
        if flips[-1] > cap:
            raise ValueError(f"hidden layer {i}: {flips[-1]} of "
                             f"{flip.numel()} values flip (at most {cap})")
        if flips[-1]:
            lo, hi = _z_preimage(hk[flip])
            zf = z[flip]
            dist = torch.clamp(torch.maximum(lo - zf, zf - hi), min=0.0)
            unit = (xr.abs() @ wr.abs())[flip] * xr.shape[-1] * 2.0 ** -24
            far = float((dist / unit).max())
            if far > flip_bound:
                raise ValueError(f"hidden layer {i}: a flip {far:.3g} units "
                                 f"from the plain sum (at most {flip_bound})")
            worst = max(worst, far)
        x = torch.where(flip, hk, h)
    last = color_branch[-1]
    return _bf16(x) @ _bf16(last["w"]) + last["b"], flips, worst


def sum_error_units(got, x, w, b=None) -> float:
    """The largest error of got, an f32 product x @ w (+ b) of bf16 values
    (so that each product is exact in f32), against the same sums in
    float64, in the units color_tail_on_roundings counts in: n 2^-24
    sum_k |x_k w_k| for n = x's columns (a sum rounded to nearest stays
    within 1, one rounded toward zero within 2; the bias's add adds at
    most about 1/n)."""
    x64, w64 = x.double(), w.double()
    exact = x64 @ w64 + (0.0 if b is None else b.double())
    err = (got.double() - exact).abs()
    unit = (x64.abs() @ w64.abs()) * x.shape[-1] * 2.0 ** -24
    return float(torch.where(err == 0, torch.zeros_like(err),
                             err / unit).max())


def fused_color_head_resources(C: int, vf: int, Nh: int, n_clayers: int,
                               bf16: bool, device=None) -> Dict[str, int]:
    """The colour head kernel's registers a thread, shared memory a block
    (bytes) and resident blocks an SM on the card."""
    import ctypes
    lib = _cuda.load("fused_agg_color")
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.fused_color_head_occupancy(
            C, vf, n_clayers, Nh, int(bf16), *(ctypes.byref(v) for v in vals))
    _cuda.check(lib, err, "fused_color_head_occupancy")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _launch_color(feat, d, w, vd, block1, alpha_branch, color_branch, K, nf,
                  df, vf, bf16, march=None):
    """K4, or K5 when `march` = (ray_dist, ray_valid, SR): K2's kernel
    (not counted under fused_block1_alpha), then the colour head's on its
    rows; one launch counted under K4's or K5's name."""
    what = ("fused_block1_alpha_color" if march is None
            else "fused_block1_alpha_color_march")
    ts = _check(feat, d, w, block1, alpha_branch, K)
    cts, Nh = _check_color(feat.shape[0], vd, block1[0]["w"].shape[1],
                           color_branch, vf,
                           () if march is None else march[:2])
    C, in0 = _check_cuda(ts + cts, feat, d, block1, K, nf, df, what)
    M, _, Fd = feat.shape
    Dd = d.shape[-1]
    if not k4_supports(K=K, F=Fd, Dd=Dd, nf=nf, df=df, C=C, bf16=bf16,
                       vf=vf, Nh=Nh, n_clayers=len(color_branch),
                       SR=0 if march is None else march[2],
                       device=feat.device):
        raise ValueError(f"{what} does not take K={K} C={C} Nh={Nh} vf={vf}"
                         " (k4_supports)")
    red = _launch_fwd(feat, d, w, block1, alpha_branch, K, nf, df, bf16,
                      count=False)
    out = _launch_head(red, vd, color_branch, vf, bf16, march)
    if march is None:
        fused_block1_alpha_color.launches += 1
    else:
        fused_block1_alpha_color_march.launches += 1
    return out


def _k3_launch(lib_fn, what, *args):
    lib = _cuda.load("fused_agg_bwd")
    err = getattr(lib, lib_fn)(*args)
    _cuda.check(lib, err, what)


def k3a_recompute(feat, d, block1, alpha_branch, *, nf: int, df: int,
                  bf16: bool):
    """K3a: K2's forward again, saving what the backward reads. Returns
    k3a_recompute_plain's (x, hs, raw); on CUDA x is a view (N, in0) of a
    buffer whose rows are padded to a multiple of 4 floats."""
    if feat.device.type == "cpu":
        return k3a_recompute_plain(feat, d, block1, alpha_branch, nf=nf,
                                   df=df, bf16=bf16)
    M, K, Fd = feat.shape
    Dd = d.shape[-1]
    in0 = Fd + 2 * Fd * nf + 2 * Dd * df
    N, C, L = M * K, block1[0]["w"].shape[1], len(block1)
    ldx = -(-in0 // 4) * 4
    Wall, Ball = _packed_block1(block1, in0, bf16)
    wa, ba = _alpha_args(alpha_branch)
    feat, d = feat.detach().contiguous(), d.detach().contiguous()
    dev = feat.device
    x = torch.empty((N, ldx), dtype=torch.float32, device=dev)
    hs = torch.empty((L, N, C), dtype=torch.float32, device=dev)
    raw = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _k3_launch("fused_agg_bwd_recompute", "K3a", _cuda.ptr(feat),
                   _cuda.ptr(d), _cuda.ptr(Wall), _cuda.ptr(Ball), L,
                   _cuda.ptr(wa), _cuda.ptr(ba), N, Fd, nf, Dd, df, C,
                   int(bf16), _cuda.ptr(x), ldx,
                   _cuda.ptr(hs), _cuda.ptr(raw), _cuda.stream_of(feat))
    return x[:, :in0], hs, raw


def _rows4(x):
    """x (N, in0) as rows of a multiple of 4 floats, unit column stride
    (K3a's buffers already are)."""
    if x.stride(1) == 1 and x.stride(0) % 4 == 0 and x.stride(0) >= x.shape[1]:
        return x, x.stride(0)
    ldx = -(-x.shape[1] // 4) * 4
    buf = x.new_zeros((x.shape[0], ldx))
    buf[:, :x.shape[1]] = x
    return buf, ldx


def k3_tiles(N: int, bf16: bool) -> int:
    """K3b's tiles of rows (alpha_part's rows on CUDA)."""
    return -(-N // TILE_ROWS[bf16])


def k3b_data_grads(x, hs, raw, w, g, block1, alpha_branch, *, K: int,
                   nf: int, df: int, F: int, bf16: bool):
    """K3b: the data-gradient chain. Returns k3b_data_grads_plain's
    (d_feat, d_d, d_w, dhs, alpha_part); on CUDA alpha_part has a row per
    tile of K3b (k3_tiles)."""
    if x.device.type == "cpu":
        return k3b_data_grads_plain(x, hs, raw, w, g, block1, alpha_branch,
                                    K=K, nf=nf, df=df, F=F, bf16=bf16)
    N, in0 = x.shape
    L, C = len(block1), block1[0]["w"].shape[1]
    Dd = (in0 - F - 2 * F * nf) // (2 * df)
    xb, ldx = _rows4(x)
    WT = _packed(pack_block1_bwd, block1, in0, bf16)
    wa, _ = _alpha_args(alpha_branch)
    hs, raw, w, g = (t.detach().contiguous() for t in (hs, raw, w, g))
    dev = x.device
    dfeat = torch.empty((N, F), dtype=torch.float32, device=dev)
    dd = torch.empty((N, Dd), dtype=torch.float32, device=dev)
    dw = torch.empty((N,), dtype=torch.float32, device=dev)
    dhs = torch.empty((L, N, C), dtype=torch.float32, device=dev)
    alpha_part = torch.empty((k3_tiles(N, bf16), C + 1), dtype=torch.float32,
                             device=dev)
    with torch.cuda.device(dev):
        _k3_launch("fused_agg_bwd_dgrad", "K3b", _cuda.ptr(xb), ldx,
                   _cuda.ptr(hs), _cuda.ptr(raw), _cuda.ptr(w), _cuda.ptr(g),
                   _cuda.ptr(WT), _cuda.ptr(wa), L, N, K, F, nf, Dd, df, C,
                   int(bf16), _cuda.ptr(dfeat), _cuda.ptr(dd), _cuda.ptr(dw),
                   _cuda.ptr(dhs), _cuda.ptr(alpha_part),
                   _cuda.stream_of(x))
    return dfeat, dd, dw, dhs, alpha_part


def wgrad_slabs(N: int):
    """K3c's fixed slabs of rows, [(lo, hi), ...] in the order their
    partials are summed: every row in exactly one, the last one partial
    where N is not a multiple of K3C_SLAB."""
    return [(lo, min(N, lo + K3C_SLAB)) for lo in range(0, N, K3C_SLAB)]


def k3c_weight_grads(x, hs, dhs, alpha_part, *, bf16: bool):
    """K3c: the weight gradients. Returns k3c_weight_grads_plain's flat
    vector (params_grad_size floats)."""
    if x.device.type == "cpu":
        return k3c_weight_grads_plain(x, hs, dhs, alpha_part, bf16=bf16)
    N, in0 = x.shape
    L, _, C = dhs.shape
    xb, ldx = _rows4(x)
    hs, dhs, alpha_part = (t.detach().contiguous()
                           for t in (hs, dhs, alpha_part))
    dev = x.device
    Sw = params_grad_size(L, in0, C) - C - 1
    partial = torch.empty((max(len(wgrad_slabs(N)), 1), Sw),
                          dtype=torch.float32, device=dev)
    out = torch.empty((Sw + C + 1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _k3_launch("fused_agg_bwd_wgrad", "K3c", _cuda.ptr(xb), ldx,
                   _cuda.ptr(hs), _cuda.ptr(dhs), _cuda.ptr(alpha_part),
                   alpha_part.shape[0], L, N, in0, C, int(bf16),
                   _cuda.ptr(partial), _cuda.ptr(out), _cuda.stream_of(x))
    return out


def fused_block1_alpha_bwd(feat, d, w, block1, alpha_branch, g, *, K: int,
                           nf: int, df: int, bf16: bool):
    """K3: the gradient of fused_block1_alpha for the cotangent g (M, C+1),
    as K3a, K3b and K3c in turn. Same returns as
    fused_block1_alpha_bwd_plain, which it runs for CPU tensors.
    `fused_block1_alpha_bwd.launches` counts backward calls that launched
    the kernels (one a call, for its three launches)."""
    ts = _check(feat, d, w, block1, alpha_branch, K)
    if feat.device.type == "cpu":
        return fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha_branch,
                                            g, K=K, nf=nf, df=df, bf16=bf16)
    C, in0 = _check_cuda(ts + [g], feat, d, block1, K, nf, df,
                         "fused_block1_alpha_bwd", max_k=None,
                         max_in=K3_MAX_IN)
    M, _, Fd = feat.shape
    if tuple(g.shape) != (M, C + 1) or g.dtype != torch.float32:
        raise ValueError(f"g must be float32 ({M}, {C + 1}), got "
                         f"{g.dtype} {tuple(g.shape)}")
    x, hs, raw = k3a_recompute(feat, d, block1, alpha_branch, nf=nf, df=df,
                               bf16=bf16)
    fused_block1_alpha_bwd.launches += 1
    dfeat, dd, dw, dhs, alpha_part = k3b_data_grads(
        x, hs, raw, w, g, block1, alpha_branch, K=K, nf=nf, df=df, F=Fd,
        bf16=bf16)
    flat = k3c_weight_grads(x, hs, dhs, alpha_part, bf16=bf16)
    dblock1, dalpha = _split_params_grad(flat, block1, alpha_branch)
    return (dfeat.view(feat.shape), dd.view(d.shape), dw.view(w.shape),
            dblock1, dalpha)


def fused_block1_alpha_bwd_resources(F: int, nf: int, Dd: int, df: int,
                                     C: int, bf16: bool, device=None):
    """K3a's, K3b's and K3c's registers a thread, shared memory a block
    (bytes) and resident blocks an SM on the card: {"K3a": {...}, ...}."""
    import ctypes
    lib = _cuda.load("fused_agg_bwd")
    vals = [(ctypes.c_int * 3)() for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.fused_agg_bwd_occupancy(F, nf, Dd, df, C, int(bf16),
                                          *(ctypes.byref(v) for v in vals))
    _cuda.check(lib, err, "fused_agg_bwd_occupancy")
    keys = ("registers", "smem_bytes", "blocks_per_sm")
    return {k3: dict(zip(keys, (v[i] for v in vals)))
            for i, k3 in enumerate(("K3a", "K3b", "K3c"))}


class _FusedBlock1Alpha(torch.autograd.Function):
    """Forward K2; backward K3 (or the plain gradient, bwd="plain")."""

    @staticmethod
    def forward(ctx, meta, feat, d, w, *weights):
        K, nf, df, bf16, _ = meta
        block1, alpha_branch = _layers(weights, [len(weights) // 2 - 1, 1])
        ctx.meta = meta
        ctx.save_for_backward(feat, d, w, *weights)
        return _launch_fwd(feat, d, w, block1, alpha_branch, K, nf, df, bf16)

    @staticmethod
    def backward(ctx, g):
        feat, d, w, *weights = ctx.saved_tensors
        K, nf, df, bf16, bwd = ctx.meta
        block1, alpha_branch = _layers(weights, [len(weights) // 2 - 1, 1])
        fn = (fused_block1_alpha_bwd if bwd == "cuda"
              else fused_block1_alpha_bwd_plain)
        dfeat, dd, dw, dblock1, dalpha = fn(
            feat, d, w, block1, alpha_branch, g.contiguous(), K=K, nf=nf,
            df=df, bf16=bf16)
        return (None, dfeat, dd, dw, *_flat(dblock1 + dalpha))


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
    out = _FusedBlock1Alpha.apply((K, nf, df, bf16, bwd), feat, d, w,
                                  *_flat(block1 + alpha_branch))
    C = block1[0]["w"].shape[1]
    return out[:, :C], out[:, C:]


def fused_block1_alpha_color_bwd(feat, d, w, vd, block1, alpha_branch,
                                 color_branch, g, *, K: int, nf: int, df: int,
                                 vf: int, bf16: bool):
    """K4's backward as the JAX package composes it (`_fused_color_bwd`,
    "pallas"): K2 re-runs the fused forward for the reduced features,
    autograd differentiates the M-row colour tail, and K3 runs the
    per-neighbour backward with the tail's feature cotangent (the kernels
    on CUDA, their plain versions on the CPU). g (M, 4) = [g_alpha | g_rgb].
    Returns (d_feat, d_d, d_w, d_vd, d_block1, d_alpha, d_color)."""
    fa, _ = fused_block1_alpha(feat, d, w, block1, alpha_branch, K=K, nf=nf,
                               df=df, bf16=bf16)
    (dfa, dvd), (dcolor,) = _vjp(
        lambda *a: color_tail_plain(*a, vf=vf, bf16=bf16), (fa, vd),
        (color_branch,), (g[:, 1:4],))
    dfeat, dd, dw, dblock1, dalpha = fused_block1_alpha_bwd(
        feat, d, w, block1, alpha_branch,
        torch.cat([dfa, g[:, 0:1]], dim=-1).contiguous(), K=K, nf=nf, df=df,
        bf16=bf16)
    return dfeat, dd, dw, dvd, dblock1, dalpha, dcolor


class _FusedBlock1AlphaColor(torch.autograd.Function):
    """Forward K4; backward K2 + the colour tail + K3 (bwd="cuda") or the
    plain gradient (bwd="plain")."""

    @staticmethod
    def forward(ctx, meta, feat, d, w, vd, *weights):
        K, nf, df, vf, bf16, _, counts = meta
        block1, alpha_branch, color_branch = _layers(weights, counts)
        ctx.meta = meta
        ctx.save_for_backward(feat, d, w, vd, *weights)
        return _launch_color(feat, d, w, vd, block1, alpha_branch,
                             color_branch, K, nf, df, vf, bf16)

    @staticmethod
    def backward(ctx, g):
        feat, d, w, vd, *weights = ctx.saved_tensors
        K, nf, df, vf, bf16, bwd, counts = ctx.meta
        fn = (fused_block1_alpha_color_bwd if bwd == "cuda"
              else fused_block1_alpha_color_bwd_plain)
        dfeat, dd, dw, dvd, dblock1, dalpha, dcolor = fn(
            feat, d, w, vd, *_layers(weights, counts), g.contiguous(), K=K,
            nf=nf, df=df, vf=vf, bf16=bf16)
        return (None, dfeat, dd, dw, dvd, *_flat(dblock1 + dalpha + dcolor))


def fused_block1_alpha_color(feat, d, w, vd, block1, alpha_branch,
                             color_branch, *, K: int, nf: int, df: int,
                             vf: int, bf16: bool, bwd: str = "cuda"):
    """K4: feat (M,K,F) f32, d (M,K,Dd), w (M,K) weight*conf (0 = masked),
    vd (M,3) rotated view directions -> (alpha (M,1), raw_color (M,3)
    pre-raw2out logits). Needs a 1-layer alpha head and vf >= 1.
    Differentiable; on CUDA the backward is K2 + the colour tail + K3
    (bwd="cuda") or the plain gradient (bwd="plain").
    `fused_block1_alpha_color.launches` counts kernel launches."""
    _check(feat, d, w, block1, alpha_branch, K)
    _check_color(feat.shape[0], vd, block1[0]["w"].shape[1], color_branch,
                 vf)
    if feat.device.type == "cpu":
        return fused_block1_alpha_color_plain(
            feat, d, w, vd, block1, alpha_branch, color_branch, K=K, nf=nf,
            df=df, vf=vf, bf16=bf16)
    if bwd not in ("cuda", "plain"):
        raise ValueError(f"bwd must be cuda or plain, got {bwd!r}")
    counts = (len(block1), 1, len(color_branch))
    out = _FusedBlock1AlphaColor.apply(
        (K, nf, df, vf, bf16, bwd, counts), feat, d, w, vd,
        *_flat(block1 + alpha_branch + color_branch))
    return out[:, 0:1], out[:, 1:4]


def fused_block1_alpha_color_march(feat, d, w, vd, ray_dist, ray_valid,
                                   block1, alpha_branch, color_branch, *,
                                   K: int, nf: int, df: int, vf: int, SR: int,
                                   bf16: bool):
    """K5, eval only (no gradient): the inputs of K4 plus ray_dist (M,) and
    ray_valid (M,) f32, M = n_rays * SR with each ray's SR points consecutive
    -> (M/SR, 4) [ray colour | background transmission].
    `fused_block1_alpha_color_march.launches` counts kernel launches."""
    _check(feat, d, w, block1, alpha_branch, K)
    M = feat.shape[0]
    if SR < 1 or M % SR:
        raise ValueError(f"M = {M} must be a multiple of SR = {SR}")
    if any(t.dtype != torch.float32 or tuple(t.shape) != (M,)
           for t in (ray_dist, ray_valid)):
        raise ValueError(f"ray_dist and ray_valid must be ({M},) float32")
    _check_color(M, vd, block1[0]["w"].shape[1], color_branch, vf,
                 (ray_dist, ray_valid))
    if feat.device.type == "cpu":
        return fused_block1_alpha_color_march_plain(
            feat, d, w, vd, ray_dist, ray_valid, block1, alpha_branch,
            color_branch, K=K, nf=nf, df=df, vf=vf, SR=SR, bf16=bf16)
    return _launch_color(feat, d, w, vd, block1, alpha_branch, color_branch,
                         K, nf, df, vf, bf16, march=(ray_dist, ray_valid, SR))


fused_block1_alpha.launches = 0
fused_block1_alpha_bwd.launches = 0
fused_block1_alpha_color.launches = 0
fused_block1_alpha_color_march.launches = 0
fused_color_head.launches = 0
