"""Parsed flags -> the port's static configs.

The flag table itself is the reference's (`sgnerf_tpu.options.options`,
numpy-only): dev_scripts parse unchanged. This module is the counterpart of
`sgnerf_tpu/options/options.py:configs_from_opt` for the eval render. Every
`auto` resolves from `torch.cuda.is_available()`: with a card the fused
KNN select (bf16 cache) and the fused aggregator kernel are on, on the CPU
their plain PyTorch versions run instead.

Flags outside this slice raise NotImplementedError naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

import torch


def _unsupported(flag: str, item: str):
    raise NotImplementedError(
        f"{flag} is not ported yet (ROADMAP.md, queue 1 {item}); run the "
        "JAX package sgnerf_tpu for it")


def _check_slice(opt):
    if int(opt.semantic_guidance) or int(opt.predict_semantic):
        _unsupported("--semantic_guidance/--predict_semantic", "item 11")
    if (int(opt.shading_feature_mlp_layer2) or int(opt.shading_feature_mlp_layer3)
            or getattr(opt, "which_agg_model", "viewmlp") != "viewmlp"):
        _unsupported("--shading_feature_mlp_layer2/3 and viewmlp_yuze",
                     "item 15")
    if int(opt.shading_feature_mlp_layer2_bpnet):
        _unsupported("--shading_feature_mlp_layer2_bpnet", "item 11")
    if int(getattr(opt, "wcoord_query", 1)) == 0:
        _unsupported("--wcoord_query 0", "item 12")
    if int(getattr(opt, "scene_shards", 0) or 0) > 1:
        _unsupported("--scene_shards", "item 19")
    if int(getattr(opt, "ray_shards", 0) or 0) not in (0, 1):
        _unsupported("--ray_shards", "item 18")
    if getattr(opt, "fused_color", "auto") == "on":
        _unsupported("--fused_color on (kernel K4)", "queue 2")
    if getattr(opt, "fused_march", "auto") == "on":
        _unsupported("--fused_march on (kernel K5)", "queue 2")
    if getattr(opt, "knn_mode", "auto") == "dedup":
        _unsupported("--knn_mode dedup (kernel K6)", "queue 2")
    if getattr(opt, "knn_mode", "auto") == "approx":
        _unsupported("--knn_mode approx", "item 17")
    if opt.gather_dtype == "int8":
        _unsupported("--gather_dtype int8", "item 17")
    if opt.which_ray_generation != "near_far_linear":
        _unsupported(f"--which_ray_generation {opt.which_ray_generation}",
                     "item 12")
    if opt.agg_distance_kernel != "linear":
        _unsupported(f"--agg_distance_kernel {opt.agg_distance_kernel}",
                     "item 15")
    if int(opt.agg_intrp_order) != 2:
        _unsupported(f"--agg_intrp_order {opt.agg_intrp_order}", "item 15")
    aw = opt.agg_axis_weight
    if aw is not None and tuple(float(a) for a in aw) != (1.0, 1.0, 1.0):
        _unsupported("non-unit --agg_axis_weight", "item 15")
    for xyz_flag in ("agg_feat_xyz_mode", "agg_alpha_xyz_mode",
                     "agg_color_xyz_mode"):
        if str(getattr(opt, xyz_flag, "None")) != "None":
            raise NotImplementedError(
                f"--{xyz_flag} != None is not supported (unused by every "
                "reference config)")


def configs_from_opt(opt):
    """opt namespace -> (RenderConfig, grid kwargs)."""
    from ..models.aggregator import AggregatorConfig
    from ..models.renderer import RenderConfig

    if opt.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError("--compute_dtype must be float32 or bfloat16, "
                         f"got {opt.compute_dtype!r}")
    if opt.gather_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError("--gather_dtype must be float32/bfloat16/int8, "
                         f"got {opt.gather_dtype!r}")
    ad = int(getattr(opt, "attr_dedup", -1))
    if ad < -1:
        raise ValueError(f"--attr_dedup must be -1 (auto) or >= 0, got {ad}")
    fused = getattr(opt, "fused_mlp", "auto")
    if fused not in ("auto", "pallas", "none"):
        raise ValueError(f"--fused_mlp must be auto/pallas/none, got {fused!r}")
    knn = getattr(opt, "knn_mode", "auto")
    if knn not in ("auto", "exact", "approx", "fused", "dedup"):
        raise ValueError(
            f"--knn_mode must be auto/exact/approx/fused, got {knn!r}")
    for flag in ("fused_color", "fused_march"):
        v = getattr(opt, flag, "auto")
        if v not in ("auto", "on", "off"):
            raise ValueError(f"--{flag} must be auto/on/off, got {v!r}")
    _check_slice(opt)

    cuda = torch.cuda.is_available()
    # "pallas" is the shared flag table's name for "force the fused kernel"
    fused_mlp = "cuda" if fused == "pallas" or (fused == "auto" and cuda) \
        else "none"
    if knn == "auto":
        knn = "fused" if cuda and opt.cache_dtype == "bfloat16" else "exact"

    agg = AggregatorConfig(
        point_features_dim=opt.point_features_dim,
        shading_feature_num=opt.shading_feature_num,
        shading_feature_mlp_layer1=opt.shading_feature_mlp_layer1,
        shading_alpha_mlp_layer=opt.shading_alpha_mlp_layer,
        shading_color_mlp_layer=opt.shading_color_mlp_layer,
        num_feat_freqs=opt.num_feat_freqs,
        dist_xyz_freq=opt.dist_xyz_freq,
        dist_xyz_deno=opt.dist_xyz_deno,
        num_viewdir_freqs=opt.num_viewdir_freqs,
        agg_dist_pers=opt.agg_dist_pers,
        agg_weight_norm=opt.agg_weight_norm,
        act_type=opt.act_type,
        act_super=opt.act_super,
        compute_dtype=opt.compute_dtype,
        fused_mlp=fused_mlp,
    )
    cfg = RenderConfig(
        agg=agg,
        z_depth_dim=opt.z_depth_dim,
        SR=opt.SR, K=opt.K,
        vsize=tuple(opt.vsize),
        radius_limit_scale=opt.radius_limit_scale,
        which_render_func=opt.which_render_func,
        which_blend_func=opt.which_blend_func,
        which_tonemap_func=opt.which_tonemap_func,
        raydist_mode_unit=opt.raydist_mode_unit,
        gather_dtype=opt.gather_dtype,
        knn_mode=knn,
        # the reference emits depth when compute_depth OR any depth loss is
        # requested (neural_points_volumetric_model.py:211)
        compute_depth=int(bool(opt.compute_depth)
                          or bool(opt.depth_loss_items)),
    )
    grid_kwargs = dict(
        vsize=list(opt.vsize), vscale=list(opt.vscale),
        kernel_size=list(opt.kernel_size),
        # occupancy dilates by QUERY_SIZE, the neighbour walk spans
        # KERNEL_SIZE (query_point_indices_worldcoords.py:797 vs :898)
        dilate_size=(list(opt.query_size)
                     if tuple(opt.query_size) != tuple(opt.kernel_size)
                     else None),
        max_o=opt.max_o, P=opt.P,
        ranges=(list(opt.ranges) if opt.ranges[0] > -99.0 else None),
        coarse_factor=opt.coarse_factor, seg_len=opt.seg_len,
        seg_cap=opt.seg_cap, cache_dtype=opt.cache_dtype,
    )
    if int(opt.coarse_factor) < 0:
        # auto: the two-level compaction is on only where it is conservative
        # (never misses a flat-path hit): (L-1)/2 * step < F * scaled vsize
        step = (float(opt.far_plane) - float(opt.near_plane)) \
            / max(int(opt.z_depth_dim), 1)
        vs = float(max(opt.vsize)) * float(max(opt.vscale))
        if step > 0 and 1.5 * step < 4.0 * vs:
            grid_kwargs.update(coarse_factor=4, seg_len=4, seg_cap=24)
        else:
            grid_kwargs.update(coarse_factor=0)
    return cfg, grid_kwargs
