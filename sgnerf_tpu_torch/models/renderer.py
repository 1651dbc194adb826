"""The render: rays -> query -> gather -> aggregate -> volume march.

Counterpart of `sgnerf_tpu/models/renderer.py` (`render_rays`,
`draw_render_noise`, `gather_and_aggregate`, `_shade_and_march`; reference
NeuralPointsRayMarching.forward, neural_points_volumetric_model.py:435-668).
Rays are never compacted: a ray whose samples hit no occupied voxel gets
sigma 0 everywhere and renders to bg_color.

Training (`is_train=True`) jitters the sample depths with uniforms drawn
by `draw_render_noise` (or passed in as `noise`, so tests can feed the
noise JAX drew); with `semantic_guidance` and a per-ray `pixel_label` the
query is guided by the points' BPNet labels (ops/query.py, with the
noise's `guide_u`). `render_rays_perspective` is Point-NeRF's
perspective-space path (`--wcoord_query 0`): the query runs on a grid of
the frame's perspective coords (ops/query_pers.py), with the train-time
shading-point jitter in that space; shading is the world path's.
Training rebuilds the attribute table from the
cloud's live tensors each call, in float32 or, with `--gather_dtype
bfloat16`, cast to bf16 (to nearest, or stochastically with
`--gather_round stochastic` on the noise's `sr_bits`); `--gather_dtype int8`
gathers a per-channel int8 copy of the float32 table in the training
forward (`gather_rows_int8`) and renders eval frames from the bf16 table.
The gather's transpose (`--gather_vjp`, the JAX package's six) is a
scatter-add in the table's dtype (`index_add_`, "scatter"), a sort and
float32 segment sum ("sorted", `gather_rows`), a float32 scatter-add
("f32"), a float32 scatter over spread_J table copies ("spread"), a
per-ray dedup of the cotangent rows through a one-hot product ("raydedup")
or a whole-batch dedup into gvjp_batch_U rows ("batchdedup"); the last two
count the rows they would drop (`gvjp_overflow` in the output, then in the
losses). Each is plain PyTorch: the JAX package computes them outside any
Pallas kernel.

`prob=True` (the growing probes, runtime/growing.py) adds per-ray stats at
the sample of largest opacity: its opacity and position, the distance to
its nearest neighbour, and the neighbours' colour, direction, confidence
and embedding averaged with weight * conf_coefficient.

`--attr_dedup` is served by the plain row gather. The reference's
`dedup_tile_gather` is a TPU one-hot-matmul way to gather each tile's
distinct rows once; below its cap it returns exactly the rows of the plain
gather, and the plain gather has no cap to overflow.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import torch

from ..ops.camera import pers2w, w2pers
from ..ops.grid import PointGrid
from ..ops.pallas_gather import sorted_segment_sum
from ..ops.march import (BLEND_FUNCS, RENDER_FUNCS, TONE_MAPS, ray_march,
                         ray_dist_from_z)
from ..ops.query import query_neighbors
from ..ops.quant import (dequantize_rows, quantize_table_int8,
                         stochastic_round_bf16)
from ..ops.query_pers import perspective_grid, query_perspective_grid
from ..ops.raygen import LAZY_RAYGENS, find_ray_generation_method
from .aggregator import AggregatorConfig, aggregate
from .point_cloud import NeuralPointCloud


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render/query configuration (the reference
    RenderConfig's fields that the eval render reads, same defaults)."""
    agg: AggregatorConfig = AggregatorConfig()
    z_depth_dim: int = 400           # raw samples per ray (D)
    SR: int = 24                     # shading points per ray
    K: int = 8                       # neighbours per shading point
    vsize: Tuple[float, float, float] = (0.008, 0.008, 0.008)
    radius_limit_scale: float = 4.0
    which_ray_generation: str = "near_far_linear"
    which_render_func: str = "radiance"
    which_blend_func: str = "alpha"
    which_tonemap_func: str = "off"
    raydist_mode_unit: int = 1
    knn_mode: str = "exact"          # "fused": kernel K1 (bf16 cache only);
    #                                  "dedup": kernel K6 over per-tile
    #                                  distinct cache rows (raster rays);
    #                                  "approx" takes the exact path
    dedup_tile: int = 64             # rays per dedup tile (consecutive)
    dedup_cap: int = 160             # distinct cache rows per tile
    gather_dtype: str = "float32"    # "bfloat16" attribute table; "int8"
    #                                  the training forward's gather
    #                                  (gather_rows_int8), bf16 at eval
    gather_round: str = "nearest"    # bf16 table cast when training:
    #                                  "stochastic" (noise's sr_bits)
    gather_vjp: str = "scatter"      # attribute-gather transpose: "scatter"
    #                                  (index_add_), "sorted", "f32",
    #                                  "spread", "raydedup", "batchdedup"
    spread_J: int = 4                # table copies of "spread"
    gvjp_rows: int = 0               # "raydedup": rows a tile (0 = SR*K)
    gvjp_U: int = 128                # ... distinct ids kept a tile
    gvjp_batch_U: int = 0            # "batchdedup": distinct ids kept a
    #                                  batch (0 = max(4096, 2/3 of rows))
    compute_depth: int = 0           # emit coarse_depth
    semantic_guidance: int = 0       # guided train-time query; the 96-d
    #                                  sem_embedding joins the attribute
    #                                  table (block2_bpnet's input)
    jitter: float = 0.3              # train-time sample jitter fraction
    domain_size: float = 1.0         # the cube generator's half extent
    shpnt_jitter: str = "passfunc"   # perspective path, train time: the
    #                                  shading points' depth jitter,
    #                                  "uniform" | "gaussian" | off

    @property
    def radius_limit(self) -> float:
        return self.radius_limit_scale * max(self.vsize[0], self.vsize[1])


def table_width(cloud: NeuralPointCloud, semantic: bool = False) -> int:
    """Columns of the packed attribute table."""
    return 10 + cloud.embedding.shape[-1] + (
        cloud.sem_embedding.shape[-1] if semantic else 0)


def attribute_table(cloud: NeuralPointCloud, gather_dtype: str,
                    semantic: bool = False, is_train: bool = False,
                    sr_bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-point attributes packed into one (N, 10+F[+S]) row table
    [xyz | embedding | color | dir | conf [| sem_embedding]]: one gather
    serves every attribute. bf16 when asked, and for int8 outside training
    (eval renders read the bf16 table); stochastically rounded by `sr_bits`
    when given. The training forward's int8 gather quantizes the float32
    table itself."""
    packed = torch.cat([cloud.xyz, cloud.embedding, cloud.color, cloud.dir,
                        cloud.conf] + ([cloud.sem_embedding] if semantic
                                       else []), dim=-1)
    if gather_dtype == "bfloat16" or (gather_dtype == "int8"
                                      and not is_train):
        if sr_bits is not None:
            return stochastic_round_bf16(packed, sr_bits)
        return packed.to(torch.bfloat16)
    return packed


def draw_render_noise(generator: torch.Generator, cfg: RenderConfig, B: int,
                      R: int, is_train: bool = True,
                      grid: Optional[PointGrid] = None,
                      guidance: bool = False,
                      perspective: bool = False,
                      table_shape: Optional[Tuple[int, int]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Every random tensor the render forward draws, from `generator` (on
    its device): raygen_u (B,R,D) sample-depth jitter uniforms when
    training with jitter > 0 (in [-1, 1) for the cube generator); on the
    perspective path, shade_u (B,R,SR), the shading points' depth jitter
    (uniform or normal, as cfg.shpnt_jitter says), when training; else with
    `guidance`, guide_u, the semantic acceptance uniforms of the
    candidates' shape: (B,R,SR,C) on the cache path, (B,R,SR,k^3,P) on the
    bucket path; sr_bits, int16 draws of the attribute table's shape
    `table_shape` (16 random bits an element, as JAX draws them), when
    training through a stochastically rounded bf16 table. Counterpart of
    the JAX draw_render_noise, whose sr_bits are `jax.random.bits(noise
    ["kg"], shape, uint16)`; the numbers differ from JAX's (the generators
    differ), so parity tests pass JAX's noise in."""
    noise: Dict[str, torch.Tensor] = {}
    dev = generator.device
    if is_train and cfg.jitter > 0:
        u = torch.rand((B, R, cfg.z_depth_dim), generator=generator,
                       device=dev)
        noise["raygen_u"] = (u * 2 - 1 if cfg.which_ray_generation == "cube"
                             else u)
    if perspective:
        if is_train and cfg.shpnt_jitter == "uniform":
            noise["shade_u"] = torch.rand((B, R, cfg.SR),
                                          generator=generator, device=dev)
        elif is_train and cfg.shpnt_jitter == "gaussian":
            noise["shade_u"] = torch.randn((B, R, cfg.SR),
                                           generator=generator, device=dev)
    elif guidance:
        spec = grid.spec
        if spec.nbr_cache > 0 and grid.nbr_packed.shape[0] > 0:
            shape = (B, R, cfg.SR, spec.nbr_cache)
        else:
            ks = spec.kernel_size
            shape = (B, R, cfg.SR, ks[0] * ks[1] * ks[2], spec.P)
        noise["guide_u"] = torch.rand(shape, generator=generator, device=dev)
    if (is_train and table_shape is not None
            and cfg.gather_dtype == "bfloat16"
            and cfg.gather_round == "stochastic"):
        noise["sr_bits"] = torch.randint(-32768, 32768, tuple(table_shape),
                                         generator=generator, device=dev,
                                         dtype=torch.int16)
    return noise


def ray_samples(cfg: RenderConfig, campos, raydir, near, far, noise,
                 is_train):
    """cfg's ray generator -> (raypos (B,R,D,3), ts (B,R,D))."""
    raygen = find_ray_generation_method(cfg.which_ray_generation)
    raypos, _, _, ts = raygen(
        campos, raydir, cfg.z_depth_dim, near=near, far=far,
        jitter=cfg.jitter if is_train else 0.0, u=noise.get("raygen_u"),
        domain_size=cfg.domain_size)
    return raypos, ts


def scatter_transpose(flat, rows, n):
    """gather_vjp "scatter": rows (M,C) summed by id flat (M,) into an
    (n,C) table in rows' dtype with `index_add_` (the JAX package's default
    transpose of `t[i]`). Autograd's own transpose of advanced indexing
    sorts the ids and walks each run of duplicates in one thread; every
    masked neighbour slot reads row 0, so that run holds most of a batch's
    rows and the sort-based transpose took ~0.1 s a step at 1024 rays on
    the card. index_add_ sums duplicates with atomics on CUDA (in no fixed
    order; in bf16 for a bf16 table) and in index order on the CPU."""
    return rows.new_zeros((n, rows.shape[1])).index_add_(0, flat, rows)


def sorted_transpose(flat, rows, n):
    """"sorted" (the JAX package's `gather_rows`): the rows sorted by id and
    each run summed in float32, cast to rows' dtype once."""
    return sorted_segment_sum(flat, rows.float(), n).to(rows.dtype)


def f32_transpose(flat, rows, n):
    """"f32" (`gather_rows_f32acc`): a float32 scatter-add, cast once."""
    return scatter_transpose(flat, rows.float(), n).to(rows.dtype)


def spread_transpose(flat, rows, n, J: int, K: int):
    """"spread" (`make_gather_rows_spread`): row i scatters in float32
    into table copy (i // K) % J (consecutive shading points rotate
    copies); the (J,n,C) copies are summed, then cast once. A J*n*C float32
    transient."""
    m, C = rows.shape
    lane = torch.div(torch.arange(m, device=flat.device), K,
                     rounding_mode="floor") % J
    dt = scatter_transpose(lane * n + flat, rows.float(), J * n)
    return dt.view(J, n, C).sum(dim=0).to(rows.dtype)


def _sorted_runs(ids):
    """ids sorted along the last axis, and where each run of equal ids
    starts."""
    s = torch.sort(ids, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    return s, first


def raydedup_transpose(flat, rows, n, T_rows: int, U: int):
    """"raydedup" (`make_gather_rows_dedup`): per tile of T_rows
    consecutive rows (one ray at T_rows = SR*K), the first U distinct ids
    (ascending; the ids past them drop, `dedup_overflow_count` counts their
    rows), each tile's duplicate rows summed into its slot by a one-hot
    product in float32 (1.0*v terms, exact; cuBLAS runs IEEE float32 as
    PyTorch's default leaves it, which the port never changes), then one
    scatter-add of tiles*U rows in rows' dtype."""
    U = min(U, T_rows)
    M, C = rows.shape
    assert M % T_rows == 0, (M, T_rows)
    NT = M // T_rows
    ids2 = flat.reshape(NT, T_rows)
    s, first = _sorted_runs(ids2)
    pos = torch.arange(T_rows, device=flat.device)
    score = torch.where(first, T_rows - pos, -1)
    # the positive scores are distinct, so the U largest are the first U
    # run starts in order; the rest tie at -1, and torch.topk may return
    # them in any order: `ok` (not that order) makes them the sentinel n
    top, topp = torch.topk(score, U, dim=1)
    uniq = torch.where(top > 0, torch.gather(s, 1, topp), n)
    inv = torch.searchsorted(uniq, ids2)
    invc = inv.clamp(0, U - 1)
    hit = torch.gather(uniq, 1, invc) == ids2
    onehot = rows.new_zeros((NT, T_rows, U), dtype=torch.float32).scatter_(
        2, invc[..., None], hit[..., None].to(torch.float32))   # (NT,T,U)
    agg = torch.einsum("ntu,ntc->nuc", onehot,
                       rows.float().reshape(NT, T_rows, C))
    return scatter_transpose(uniq.clamp(0, n - 1).reshape(-1),
                             agg.reshape(-1, C).to(rows.dtype), n)


def batchdedup_transpose(flat, rows, n, U_cap: int):
    """"batchdedup" (`make_gather_rows_batchdedup`): the batch's distinct
    ids ranked by a sort, the first U_cap of them kept (the rest drop,
    `batchdedup_overflow_count` counts them), the rows summed by rank in
    float32 into U_cap rows, then one scatter-add of those rows, cast to
    rows' dtype, into the table. JAX drops the out-of-range ranks and ids
    (`mode="drop"`); here they land in a spare row that is cut off."""
    s, first = _sorted_runs(flat)
    rank_sorted = torch.cumsum(first, 0) - 1
    # uniq[r] = the id of rank r (duplicate writes carry equal values);
    # slot U_cap is the spare, the slots past the distinct count hold n
    uniq = torch.full((U_cap + 1,), n, dtype=flat.dtype, device=flat.device)
    uniq[rank_sorted.clamp(max=U_cap)] = s
    uniq = uniq[:U_cap]
    rank = torch.searchsorted(uniq, flat)        # U_cap past the kept ids
    compact = scatter_transpose(rank, rows.float(), U_cap + 1)[:U_cap]
    return scatter_transpose(uniq, compact.to(rows.dtype), n + 1)[:n]


def batchdedup_overflow_count(pid: torch.Tensor, U_cap: int) -> torch.Tensor:
    """Distinct ids past batchdedup's U_cap (their gradient rows drop)."""
    n_uniq = _sorted_runs(pid.reshape(-1).clamp(min=0))[1].sum()
    return (n_uniq - U_cap).clamp(min=0).to(torch.int32)


def dedup_overflow_count(pid: torch.Tensor, T_rows: int,
                         U: int) -> torch.Tensor:
    """Neighbour rows whose gradient raydedup drops (distinct-id rank >= U
    within a tile of T_rows); -1 when the rows do not tile."""
    flat = pid.reshape(-1)
    M = flat.shape[0]
    if M % T_rows:
        return torch.tensor(-1, dtype=torch.int32, device=pid.device)
    _, first = _sorted_runs(flat.clamp(min=0).reshape(M // T_rows, T_rows))
    rank = torch.cumsum(first, dim=1) - 1
    return (rank >= U).sum().to(torch.int32)


class _Gather(torch.autograd.Function):
    """table (N,C) [idx] whose VJP is `transpose(flat_idx, cotangent rows
    (M,C), N)` -> (N,C) in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, table, idx, transpose):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.transpose = table.shape[0], transpose
        return table.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1)
        gt = ctx.transpose(flat, g.reshape(flat.shape[0], -1), ctx.n_rows)
        return gt.reshape((ctx.n_rows,) + g.shape[idx.dim():]), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] whose transpose sorts the cotangent rows by index and sums
    each run in float32, then casts to the cotangent's dtype (the JAX
    package's `gather_rows`, `--gather_vjp sorted`): a bf16 table's
    duplicate ids are summed without bf16 rounding between terms. Unlike
    K7's transpose (`ops/pallas_gather.py`), which sums in the cotangent's
    own dtype; the two share the sort and segment step."""
    return _Gather.apply(table, idx, sorted_transpose)


class _GatherInt8(torch.autograd.Function):
    """The training forward's int8 gather (the JAX package's
    `gather_rows_int8`): the float32 table quantized per channel over the
    active rows, int8 rows gathered, dequantized to float32; the VJP is a
    bf16 scatter-add and one upcast to float32, the bf16 table's default
    transpose. The float32 master takes the gradient."""

    @staticmethod
    def forward(ctx, table, idx, active):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        q, scale, zero = quantize_table_int8(table, active)
        rows = q.index_select(0, idx.reshape(-1))
        return dequantize_rows(rows, scale, zero).reshape(
            idx.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1)
        gt = scatter_transpose(
            flat, g.reshape(flat.shape[0], -1).to(torch.bfloat16),
            ctx.n_rows)
        return gt.float().reshape((ctx.n_rows,) + g.shape[idx.dim():]), \
            None, None


def gather_rows_int8(table: torch.Tensor, idx: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """table (N,C) float32 [idx] through its int8 quantization (quant.py);
    float32 rows out."""
    return _GatherInt8.apply(table, idx, active)


def _dedup_caps(cfg: "RenderConfig", rows: int):
    """raydedup's rows a tile, and batchdedup's distinct-id slots for a
    batch of `rows` neighbour rows."""
    return (cfg.gvjp_rows or cfg.SR * cfg.K,
            cfg.gvjp_batch_U or max(4096, rows * 2 // 3))


def gather_transpose(cfg: "RenderConfig", rows: int):
    """The transpose `--gather_vjp` names (the JAX package's dispatch), for
    a batch of `rows` neighbour rows."""
    v = cfg.gather_vjp
    T_rows, U_cap = _dedup_caps(cfg, rows)
    if v == "sorted":
        return sorted_transpose
    if v == "f32":
        return f32_transpose
    if v == "spread":
        return partial(spread_transpose, J=cfg.spread_J, K=cfg.K)
    if v == "raydedup":
        return partial(raydedup_transpose, T_rows=T_rows, U=cfg.gvjp_U)
    if v == "batchdedup":
        return partial(batchdedup_transpose, U_cap=U_cap)
    return scatter_transpose


def gather_overflow(cfg: "RenderConfig", pid: torch.Tensor):
    """The neighbour rows (raydedup) or distinct ids (batchdedup) whose
    gradient the training transpose drops; None for the other four."""
    T_rows, U_cap = _dedup_caps(cfg, pid.numel())
    if cfg.gather_vjp == "raydedup":
        return dedup_overflow_count(pid, T_rows, cfg.gvjp_U)
    if cfg.gather_vjp == "batchdedup":
        return batchdedup_overflow_count(pid, U_cap)
    return None


def table_shape_of(cloud: NeuralPointCloud, cfg: RenderConfig):
    return (cloud.capacity, table_width(cloud, bool(cfg.semantic_guidance)))


def step_table(cloud: NeuralPointCloud, cfg: RenderConfig, noise, is_train):
    """The step's attribute table: stochastically rounded on the noise's
    sr_bits when training with --gather_round stochastic."""
    sr_bits = None
    if (is_train and cfg.gather_dtype == "bfloat16"
            and cfg.gather_round == "stochastic"):
        sr_bits = noise.get("sr_bits")
        if sr_bits is None:
            raise ValueError("--gather_round stochastic trains on the "
                             "noise's sr_bits (draw_render_noise with "
                             "table_shape)")
    return attribute_table(cloud, cfg.gather_dtype,
                           bool(cfg.semantic_guidance), is_train, sr_bits)


def render_rays(params: Dict, cloud: NeuralPointCloud, grid: PointGrid,
                cfg: RenderConfig, *, campos: torch.Tensor,
                raydir: torch.Tensor, camrotc2w: torch.Tensor, near, far,
                bg_color: Optional[torch.Tensor] = None,
                table: Optional[torch.Tensor] = None,
                pixel_label: Optional[torch.Tensor] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                is_train: bool = False,
                prob: bool = False) -> Dict[str, torch.Tensor]:
    """campos (B,3), raydir (B,R,3), camrotc2w (B,3,3) -> output dict with
    coarse_raycolor (B,R,3) and the per-sample march terms. `table` is the
    packed attribute table, built from the cloud when not given (a training
    caller that gives one builds it with `step_table`, so the gradient
    reaches the cloud). `noise` (or draws from `generator`) jitters
    the samples when `is_train`; when training with cfg.semantic_guidance,
    `pixel_label` (B,R) guides the query. `prob` adds the growing probes'
    outputs."""
    B, R, _ = raydir.shape
    use_sem = (bool(cfg.semantic_guidance) and is_train
               and pixel_label is not None)
    if noise is None and generator is not None:
        noise = draw_render_noise(generator, cfg, B, R, is_train=is_train,
                                  grid=grid, guidance=use_sem,
                                  table_shape=table_shape_of(cloud, cfg))
    noise = noise or {}
    raypos, ray_ts = ray_samples(cfg, campos, raydir, near, far, noise,
                                  is_train)
    # with the two-level compaction on, positions are recomputed from
    # (campos, dir, t) for the selected samples only, where the generator's
    # positions are campos + t * dir
    lazy = cfg.which_ray_generation in LAZY_RAYGENS
    q = query_neighbors(grid, raypos, K=cfg.K,
                        SR=cfg.SR, radius_limit=cfg.radius_limit,
                        knn_mode=cfg.knn_mode,
                        campos=campos if lazy else None,
                        raydir=raydir if lazy else None,
                        tvals=ray_ts if lazy else None,
                        dedup_tile=cfg.dedup_tile,
                        dedup_cap=cfg.dedup_cap,
                        ray_label=pixel_label if use_sem else None,
                        points_label=cloud.label if use_sem else None,
                        points_label_prob=(cloud.label_prob if use_sem
                                           else None),
                        guide_u=noise.get("guide_u"))
    if table is None:
        table = step_table(cloud, cfg, noise, is_train)
    return _shade_and_march(params, cloud, cfg, table, q.sample_pidx,
                            q.sample_loc_w, q.ray_mask, campos, raydir,
                            camrotc2w, bg_color, is_train, prob)


def render_rays_perspective(params: Dict, cloud: NeuralPointCloud, pspec,
                            cfg: RenderConfig, *, campos: torch.Tensor,
                            raydir: torch.Tensor, camrotc2w: torch.Tensor,
                            near, far,
                            bg_color: Optional[torch.Tensor] = None,
                            table: Optional[torch.Tensor] = None,
                            noise: Optional[Dict[str, torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None,
                            is_train: bool = False,
                            pgrid=None) -> Dict[str, torch.Tensor]:
    """Point-NeRF's perspective-space path (--wcoord_query 0, reference
    query_point_indices.py): the frame's grid is built in camera 0's
    perspective space on the static frustum spec `pspec`
    (ops/query_pers.py; `pgrid`, when given, is that grid, built once for
    the frame's chunks), then shading and march run as in render_rays.
    Training jitters the shading points' depth in that space by the
    noise's `shade_u` (reference query_point_indices.py:96: uniform within
    +-vsize_z/2; gaussian, std vsize_z/4 clipped to +-vsize_z/2)."""
    B, R, _ = raydir.shape
    if noise is None and generator is not None:
        noise = draw_render_noise(generator, cfg, B, R, is_train=is_train,
                                  perspective=True,
                                  table_shape=table_shape_of(cloud, cfg))
    noise = noise or {}
    raypos, _ = ray_samples(cfg, campos, raydir, near, far, noise, is_train)
    if pgrid is None:
        pgrid, _ = perspective_grid(cloud.xyz, cloud.active, camrotc2w[0],
                                    campos[0], pspec)
    res = query_perspective_grid(pgrid, raypos, camrotc2w[0], campos[0],
                                 K=cfg.K, SR=cfg.SR,
                                 radius_limit=cfg.radius_limit)
    loc_p = res.sample_loc_w              # perspective shading coords
    shade_u = noise.get("shade_u")
    if is_train and shade_u is not None and cfg.shpnt_jitter in (
            "uniform", "gaussian"):
        vz = pspec.vsize[2]
        j = ((shade_u - 0.5) * vz if cfg.shpnt_jitter == "uniform"
             else torch.clamp(shade_u * (vz / 4), -vz / 2, vz / 2))
        j = torch.where(res.sample_loc_mask, j, torch.zeros_like(j))
        loc_p = torch.cat([loc_p[..., :2], loc_p[..., 2:] + j[..., None]],
                          dim=-1)
    # lifted back to world coords for the shared shading path
    loc_w = pers2w(loc_p.reshape(-1, 3), camrotc2w[0],
                   campos[0]).reshape(loc_p.shape)
    loc_w = torch.where(res.sample_loc_mask[..., None], loc_w,
                        torch.zeros_like(loc_w))
    if table is None:
        table = step_table(cloud, cfg, noise, is_train)
    return _shade_and_march(params, cloud, cfg, table, res.sample_pidx,
                            loc_w, res.ray_mask, campos, raydir, camrotc2w,
                            bg_color, is_train)


def gather_and_aggregate(params, cloud, cfg: RenderConfig, table, sample_pidx,
                         sample_loc_w, campos, raydir, camrotc2w,
                         fuse_march=False, is_train=False):
    """Neighbour-attribute gather + per-neighbour aggregation. Returns
    (decoded (B,R,SR,4), ray_valid, weight, conf_coefficient, sample_loc
    (perspective coords), sampled: the gathered xyz, embedding, color, dir
    and conf (B,R,SR,K,.) for the growing probes, and when training under
    raydedup or batchdedup the rows that transpose drops, gvjp_overflow);
    with `fuse_march` the aggregation marches in kernel K5 and decoded is
    {"march": (B,R,4)}."""
    B, R, _ = raydir.shape
    agg = cfg.agg
    mask = sample_pidx >= 0
    pid = sample_pidx.clamp(0, cloud.capacity - 1).long()
    overflow = None
    if cfg.gather_dtype == "int8" and is_train:
        # int8 carries its own transpose (configs_from_opt refuses it
        # beside another gather_vjp too)
        if cfg.gather_vjp != "scatter":
            raise ValueError("gather_dtype=int8 requires gather_vjp=scatter")
        g = gather_rows_int8(table, pid, cloud.active)
    else:
        g = _Gather.apply(table, pid, gather_transpose(
            cfg, pid.numel())).to(torch.float32)
        if is_train:
            # surfaced into the losses, so the periodic prints show when a
            # config makes the transpose lossy
            overflow = gather_overflow(cfg, pid)
    F = cloud.embedding.shape[-1]
    # zero the padding gathers so masked rows stay finite
    sampled_xyz = g[..., 0:3] * mask[..., None]
    sampled_embedding = g[..., 3:3 + F] * mask[..., None]
    sampled_color = g[..., 3 + F:6 + F]
    sampled_dir = g[..., 6 + F:9 + F]
    sampled_conf = g[..., 9 + F:10 + F]
    sampled_sem = g[..., 10 + F:] if cfg.semantic_guidance else None

    pers = torch.stack([w2pers(sampled_xyz[b].reshape(-1, 3), camrotc2w[b],
                               campos[b]) for b in range(B)]).reshape(
        sampled_xyz.shape)
    sample_loc = torch.stack([w2pers(sample_loc_w[b].reshape(-1, 3),
                                     camrotc2w[b], campos[b])
                              for b in range(B)]).reshape(sample_loc_w.shape)
    # an edited scene: a per-part rotation table (T,3,3) and each point's
    # row, gathered per neighbour (the reference gathers a dense per-point
    # (N,3,3) Rw2c, point_aggregators.py:568); an empty slot takes point
    # 0's row, as pid does
    rot = cloud.Rw2c
    if rot.dim() == 3:
        rot = rot[cloud.rot_idx[pid].long()]          # (B,R,SR,K,3,3)
    march = None
    if fuse_march:
        # the march's per-sample distances are known before aggregation
        march = {"ray_dist": ray_dist_from_z(
            sample_loc[..., 2], mask.any(dim=-1), cfg.vsize[2],
            cfg.raydist_mode_unit)}
    decoded, ray_valid, weight, conf_coefficient = aggregate(
        params, agg,
        sampled_embedding=sampled_embedding,
        sampled_conf=sampled_conf,
        sampled_label_embedding=sampled_sem,
        sampled_color=sampled_color,
        sampled_dir=sampled_dir,
        sampled_xyz=sampled_xyz,
        sampled_xyz_pers=pers,
        sample_pnt_mask=mask,
        sample_loc=sample_loc,
        sample_loc_w=sample_loc_w,
        sample_ray_dirs=raydir[:, :, None, :].expand(B, R, cfg.SR, 3),
        Rw2c=rot, vsize=cfg.vsize, march=march)
    sampled = {"xyz": sampled_xyz, "embedding": sampled_embedding,
               "color": sampled_color, "dir": sampled_dir,
               "conf": sampled_conf}
    if overflow is not None:
        sampled["gvjp_overflow"] = overflow
    return decoded, ray_valid, weight, conf_coefficient, sample_loc, sampled


def _shade_and_march(params, cloud, cfg: RenderConfig, table, sample_pidx,
                     sample_loc_w, ray_mask, campos, raydir, camrotc2w,
                     bg_color, is_train=False, prob=False):
    """Everything downstream of the neighbour query."""
    B, R, _ = raydir.shape
    # --fused_march: shading and march in kernel K5, for eval renders of the
    # radiance/alpha/off tail the kernel implements (training and the probes
    # need the per-sample outputs)
    fuse_march = (cfg.agg.fused_march and not is_train and not prob
                  and cfg.which_render_func == "radiance"
                  and cfg.which_blend_func == "alpha"
                  and cfg.which_tonemap_func == "off"
                  and cfg.agg.act_super > 0)
    decoded, ray_valid, weight, conf_coefficient, sample_loc, sampled = \
        gather_and_aggregate(params, cloud, cfg, table, sample_pidx,
                             sample_loc_w, campos, raydir, camrotc2w,
                             fuse_march=fuse_march, is_train=is_train)
    queried_shading = (~ray_valid.any(dim=-1, keepdim=True)).to(
        torch.float32).expand(B, R, 3)
    if isinstance(decoded, dict):                 # K5 marched in-kernel
        out4 = decoded["march"]                   # (B,R,4) [colour | bgT]
        color = out4[..., :3]
        if bg_color is not None:
            color = color + torch.as_tensor(
                bg_color, dtype=out4.dtype,
                device=out4.device).reshape(-1, 1, 3) * out4[..., 3:]
        return {"coarse_raycolor": color,
                "coarse_is_background": out4[..., 3:],
                "queried_shading": queried_shading,
                "ray_mask": ray_mask, "ray_valid": ray_valid}
    ray_dist = ray_dist_from_z(sample_loc[..., 2], ray_valid, cfg.vsize[2],
                               cfg.raydist_mode_unit)
    (ray_color, _, opacity, acc_transmission, blend_weight,
     background_transmission, _) = ray_march(
        ray_dist, ray_valid, decoded, RENDER_FUNCS[cfg.which_render_func],
        BLEND_FUNCS[cfg.which_blend_func], bg_color)
    output = {
        "coarse_raycolor": TONE_MAPS[cfg.which_tonemap_func](ray_color),
        "coarse_point_opacity": opacity,                    # (B,R,SR)
        "coarse_is_background": background_transmission,    # (B,R,1)
        "queried_shading": queried_shading,
        "ray_mask": ray_mask,                               # (B,R) bool
        "ray_valid": ray_valid,
        "weight": weight.detach(),
        "blend_weight": blend_weight.detach(),
        "conf_coefficient": conf_coefficient,
    }
    if "gvjp_overflow" in sampled:
        output["gvjp_overflow"] = sampled["gvjp_overflow"]
    if cfg.compute_depth:
        # alpha-blend-weighted mean camera-space depth (reference
        # return_depth, neural_points_volumetric_model.py:620-624)
        w = opacity * acc_transmission
        output["coarse_depth"] = ((w * sample_loc[..., 2]).sum(-1)
                                  / (w.sum(-1) + 1e-6))
    if prob:
        output.update(_probe_outputs(opacity, sample_loc_w, weight,
                                     conf_coefficient, sampled))
    return output


def _probe_outputs(opacity, sample_loc_w, weight, conf_coefficient,
                   sampled) -> Dict[str, torch.Tensor]:
    """Per ray, the growing probes' stats at its sample of largest opacity
    (reference neural_points_volumetric_model.py:633-668). The first such
    sample, as jnp.argmax picks it: torch.argmax does not promise the
    first of equal maxima on CUDA."""
    B, R, SR = opacity.shape
    max_op = opacity.max(dim=-1, keepdim=True).values       # (B,R,1)
    pos = torch.arange(SR, device=opacity.device)
    ind = torch.where(opacity == max_op, pos,
                      torch.full_like(pos, SR)).min(dim=-1).values

    def take(a):             # a (B,R,SR,...) -> (B,R,...) at sample ind
        idx = ind.reshape(B, R, 1, *([1] * (a.dim() - 3))).expand(
            B, R, 1, *a.shape[3:])
        return torch.gather(a, 2, idx)[:, :, 0]

    loc = take(sample_loc_w)                                 # (B,R,3)
    wsel = take(weight * conf_coefficient)[..., None]        # (B,R,K,1)
    far = torch.linalg.norm(take(sampled["xyz"]) - loc[:, :, None, :],
                            dim=-1).min(dim=-1, keepdim=True).values
    out = {"ray_max_shading_opacity": max_op, "ray_max_sample_loc_w": loc,
           "ray_max_far_dist": far}
    for k in ("color", "dir", "conf", "embedding"):
        out[f"shading_avg_{k}"] = (take(sampled[k]) * wsel).sum(-2)
    return out
