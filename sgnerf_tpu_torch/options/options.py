"""Command-line flags -> the port's static configs.

The flag table is the reference's (names, types and defaults of the
reference options/{base,train,test,edit}_options.py plus the flags its
model and dataset classes inject), flattened into one table so the
dev_scripts parse unchanged; tests/test_torch_import.py holds it equal to
the JAX package's table. Unknown flags are warned about and ignored.

`configs_from_opt` is the counterpart of the JAX package's
`options.configs_from_opt` for the ported slices. The device comes from
`--gpu_ids` (Point-NeRF/pix2pix meaning: -1 is the CPU, otherwise
`cuda:<first id>`), and every `auto` resolves from that device, never from
what the machine happens to have: on CUDA the kernels run (fused KNN select
with a bf16 cache, fused aggregator forward and backward; `--fused_color
on` and `--fused_march on` opt into K4 and K5 as in the JAX package), on
the CPU their plain PyTorch versions. `knn_mode="dedup"` (K6) is reached
through `RenderConfig` only, as in the JAX package: the CLI refuses it;
`--knn_mode approx` takes the exact select, which JAX's approx_max_k is
off the TPU. The opt-in training gathers are the JAX package's:
`--gather_dtype bfloat16|int8`, `--gather_round stochastic` and the six
`--gather_vjp` transposes (scatter, sorted, f32, spread, raydedup,
batchdedup; `models/renderer.py`), refused with JAX's ValueErrors.
`--ray_shards N` (rays split over N devices) and `--scene_shards N` (the
scene cut into N x-slabs) run on the devices `--gpu_ids` lists, one id a
shard and repeats allowed (`0,0`: two shards on card 0; `-1,-1`: two on
the CPU); `--ray_shards -1` takes one shard a listed id. Fewer ids than
shards, or both flags at once, raise ValueError: nothing falls back to
fewer shards (`shard_devices`).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

# (name, type, default, nargs); a repeated name keeps its first entry
_F = [
    ('name', str, None, None), ('data_root', str, None, None),
    ('n_threads', int, 1, None), ('batch_size', int, 1, None),
    ('render_only', int, 0, None), ('serial_batches', int, 0, None),
    ('gpu_ids', str, '0', None),
    ('checkpoints_dir', str, './checkpoints', None),
    ('show_tensorboard', int, 0, None), ('resume_dir', str, '', None),
    ('resume_iter', str, 'latest', None), ('debug', bool, False, 'store_true'),
    ('vid', int, 0, None), ('resample_pnts', int, -1, None),
    ('inall_img', int, 1, None), ('test_train', int, 0, None),
    ('model', str, 'mvs_points_volumetric', None),
    ('dataset_name', str, None, None),
    ('max_dataset_size', int, 2147483648, None), ('mode', int, 0, None),
    ('verbose', bool, False, 'store_true'),
    ('timestamp', bool, False, 'store_true'), ('plr', float, 0.0005, None),
    ('lr', float, 0.001, None), ('lr_policy', str, 'lambda', None),
    ('lr_decay_iters', int, 50, None), ('lr_decay_exp', float, 0.1, None),
    ('train_and_test', int, 0, None), ('test_num', int, 1, None),
    ('test_num_step', int, 1, None), ('test_freq', int, 500, None),
    ('maximum_step', int, None, None), ('niter', int, 100, None),
    ('niter_decay', int, 100, None), ('save_iter_freq', int, 100000, None),
    ('save_point_freq', int, 100000, None), ('print_freq', int, 100, None),
    ('prune_thresh', float, 0.1, None), ('prune_iter', int, -1, None),
    ('prune_max_iter', int, 9999999, None), ('alpha_range', int, 0, None),
    ('prob_freq', int, 0, None), ('prob_num_step', int, 100, None),
    ('prob_mode', int, 0, None), ('prob_top', int, 1, None),
    ('prob_mul', float, 1.0, None), ('prob_thresh', float, 0.8, None),
    ('prob_kernel_size', float, None, '+'),
    ('prob_tiers', int, (250000,), '+'), ('far_thresh', float, -1.0, None),
    ('comb_file', str, None, None), ('save_label_iter', int, 100000, None),
    ('save_predict_label', int, 0, None), ('test_printId', int, 0, None),
    ('test_list', int, None, '+'), ('train_step', int, 50, None),
    ('train_load_num', int, 0, None), ('alter_step', int, 0, None),
    ('feedforward', int, 0, None), ('no_loss', int, 0, None),
    ('neural_points_names', str, None, '+'), ('render_name', str, None, None),
    ('parts_index_names', str, None, '+'),
    ('Transformation_names', str, None, '+'), ('render_stride', int, 30, None),
    ('render_radius', float, 4.0, None), ('out_channels', int, None, None),
    ('which_ray_generation', str, 'cube', None), ('domain_size', int, 1, None),
    ('which_render_func', str, 'microfacet', None),
    ('which_blend_func', str, 'alpha', None),
    ('which_tonemap_func', str, 'gamma', None),
    ('num_pos_freqs', int, -1, None), ('num_viewdir_freqs', int, -1, None),
    ('num_feature_freqs', int, -1, None), ('random_sample', str, 'none', None),
    ('random_sample_size', int, 1024, None),
    ('color_loss_items', str, None, '+'),
    ('color_loss_weights', float, (1.0,), '+'),
    ('test_color_loss_items', str, None, '+'),
    ('depth_loss_items', str, (), '+'),
    ('depth_loss_weights', float, (1.0,), '+'),
    ('bg_loss_items', str, (), '+'), ('bg_loss_weights', float, (1.0,), '+'),
    ('zero_one_loss_items', str, (), '+'),
    ('zero_one_loss_weights', float, (1.0,), '+'),
    ('l2_size_loss_items', str, (), '+'),
    ('l2_size_loss_weights', float, (0.0,), '+'),
    ('zero_epsilon', float, 0.001, None),
    ('sparse_loss_weight', float, 0.0, None), ('compute_depth', int, 0, None),
    ('bgmodel', str, 'No', None), ('visual_items', str, None, '*'),
    ('visual_items_additional', str, (), '+'),
    ('add_shading_dist', int, 0, None), ('raydist_mode_unit', int, 0, None),
    ('load_points', int, 1, None), ('num_point', int, 8192, None),
    ('construct_res', int, 0, None), ('grid_res', int, 0, None),
    ('cloud_path', str, '', None), ('shpnt_jitter', str, 'passfunc', None),
    ('point_noise', str, '', None), ('num_each_depth', int, 1, None),
    ('vscale', int, (2, 2, 2), '+'),
    ('vsize', float, (0.005, 0.005, 0.005), '+'),
    ('wcoord_query', int, 0, None),
    ('ranges', float, (-100.0, -100.0, -100.0, 100.0, 100.0, 100.0), '+'),
    ('z_depth_dim', int, 400, None), ('max_o', int, None, None),
    ('SR', int, 24, None), ('K', int, 32, None), ('P', int, 16, None),
    ('NN', int, 0, None), ('gpu_maxthr', int, 1024, None),
    ('kernel_size', int, (7, 7, 7), '+'), ('query_size', int, (0, 0, 0), '+'),
    ('radius_limit_scale', float, 5.0, None),
    ('depth_limit_scale', float, 1.3, None), ('xyz_grad', int, 0, None),
    ('feat_grad', int, 1, None), ('conf_grad', int, 1, None),
    ('color_grad', int, 1, None), ('dir_grad', int, 0, None),
    ('bp_embedding_grad', int, 0, None),
    ('feature_init_method', str, 'rand', None),
    ('point_features_dim', int, 64, None), ('point_conf_mode', str, '0', None),
    ('point_color_mode', str, '0', None), ('point_dir_mode', str, '0', None),
    ('default_conf', float, -1.0, None), ('embedding_size', int, -1, None),
    ('semantic_guidance', int, 0, None),
    ('which_agg_model', str, 'viewmlp', None),
    ('agg_distance_kernel', str, 'quadric', None), ('sh_degree', int, 4, None),
    ('sh_dist_func', str, 'sh_quadric', None),
    ('sh_act', str, 'sigmoid', None), ('agg_axis_weight', float, None, '+'),
    ('agg_dist_pers', int, 1, None), ('apply_pnt_mask', int, 1, None),
    ('modulator_concat', int, 0, None), ('agg_intrp_order', int, 0, None),
    ('shading_feature_mlp_layer0', int, 0, None),
    ('shading_feature_mlp_layer1', int, 2, None),
    ('shading_feature_mlp_layer2', int, 0, None),
    ('shading_feature_mlp_layer2_bpnet', int, 0, None),
    ('shading_feature_mlp_layer3', int, 0, None),
    ('shading_feature_mlp_layer4', int, 1, None),
    ('shading_feature_mlp_linear', int, 0, None),
    ('shading_feature_num', int, 256, None),
    ('point_hyper_dim', int, 256, None),
    ('shading_alpha_mlp_layer', int, 1, None),
    ('shading_color_mlp_layer', int, 1, None),
    ('shading_color_channel_num', int, 3, None),
    ('num_feat_freqs', int, 0, None), ('num_hyperfeat_freqs', int, 0, None),
    ('dist_xyz_freq', int, 2, None), ('dist_xyz_deno', float, 0.0, None),
    ('weight_xyz_freq', int, 2, None), ('weight_feat_dim', int, 8, None),
    ('agg_weight_norm', int, 1, None), ('view_ori', int, 0, None),
    ('agg_feat_xyz_mode', str, 'None', None),
    ('agg_alpha_xyz_mode', str, 'None', None),
    ('agg_color_xyz_mode', str, 'None', None), ('act_type', str, 'ReLU', None),
    ('act_super', int, 1, None), ('prob', int, 0, None),
    ('pad', int, 24, None), ('far_plane_shift', float, None, None),
    ('neural_point_dir', str, None, None),
    ('gather_dtype', str, 'float32', None),
    ('gather_round', str, 'nearest', None),
    ('gather_vjp', str, 'scatter', None), ('gvjp_U', int, 128, None),
    ('gvjp_batch_U', int, 0, None), ('attr_dedup', int, -1, None),
    ('attr_tile', int, 64, None), ('compute_dtype', str, 'float32', None),
    ('fused_mlp', str, 'auto', None), ('fused_color', str, 'auto', None),
    ('fused_bwd', str, 'auto', None), ('fused_march', str, 'auto', None),
    ('chunk_stack', int, 1, None), ('knn_mode', str, 'auto', None),
    ('coarse_factor', int, -1, None), ('seg_len', int, 4, None),
    ('seg_cap', int, 32, None), ('profile_dir', str, '', None),
    ('profile_start', int, 10, None), ('profile_steps', int, 10, None),
    ('cache_dtype', str, 'float32', None),
    ('bpnet_dtype', str, 'float32', None),
    ('steps_per_dispatch', int, 1, None), ('scene_shards', int, 0, None),
    ('ray_shards', int, 0, None), ('dtu_cam_scale', float, 4.0, None),
    ('dtu_light_idx', int, 3, None), ('predict_semantic', int, 0, None),
    ('layers_2d', int, 34, None), ('bpnet_refresh_every', int, 1, None),
    ('bpnet_aug', int, 0, None), ('classes', int, 20, None),
    ('arch_3d', str, 'MinkUNet18A', None),
    ('bpnetweight', str, '../bpnetInitmodel/bpnet_5cm.pth.tar', None),
    ('bpnet_lr', float, 0.01, None), ('bpnet_momentum', float, 0.9, None),
    ('bpnet_weight_decay', float, 0.0001, None),
    ('pre_d_est', str, None, None), ('depth_vid', str, '0', None),
    ('manual_depth_view', int, 0, None),
    ('manual_std_depth', float, 0.0, None),
    ('depth_conf_thresh', float, None, None), ('geo_cnsst_num', int, 2, None),
    ('depth_occ', int, 0, None), ('depth_grid', int, 128, None),
    ('dprob_thresh', float, 0.8, None), ('num_neighbor', int, 1, None),
    ('mvs_lr', float, 0.0005, None),
    ('mvs_point_sampler', str, 'gau_single_sampler', None),
    ('appr_feature_str0', str, ('imgfeat_0_0123', 'dir_0', 'point_conf'), '+'),
    ('appr_feature_str1', str, ('imgfeat_0_0123', 'dir_0', 'point_conf'), '+'),
    ('appr_feature_str2', str, ('imgfeat_0_0123', 'dir_0', 'point_conf'), '+'),
    ('appr_feature_str3', str, ('imgfeat_0_0123', 'dir_0', 'point_conf'), '+'),
    ('inverse', int, 0, None), ('ref_vid', int, 0, None),
    ('uni_depth', int, 0, None), ('full_comb', int, 0, None),
    ('scan', str, 'scan1', None), ('init_view_num', int, 3, None),
    ('edge_filter', int, 3, None), ('shape_id', int, 0, None),
    ('trgt_id', int, 0, None), ('num_nn', int, 1, None),
    ('near_plane', float, 0.5, None), ('far_plane', float, 5.0, None),
    ('bg_color', str, 'white', None), ('inverse_gamma_image', int, -1, None),
    ('pin_data_in_memory', int, -1, None), ('normview', int, 0, None),
    ('id_range', int, (0, 385, 1), 3), ('id_list', int, None, '+'),
    ('split', str, 'train', None), ('vox_res', int, 0, None),
    ('dir_norm', int, 0, None), ('train_load_num2', int, 0, None),
    ('img_wh', int, (640, 480), 2), ('testskip', int, 8, None),
    ('half_res', bool, False, 'store_true'),
    ('novel_cam_trajectory', str, '0', None),
    ('loss_embedding_l2_weight', float, -1, None),
    ('loss_kld_weight', float, -1, None),
]


class BaseOptions:
    is_train = False

    def __init__(self):
        self.parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        seen = set()
        for name, ty, default, nargs in _F:
            if name in seen:
                continue
            seen.add(name)
            kw = {}
            if nargs == "store_true":
                kw["action"] = "store_true"
            else:
                kw["type"] = ty
                if nargs:
                    kw["nargs"] = nargs
            kw["default"] = default
            self.parser.add_argument(f"--{name}", **kw)

    def parse(self, args=None):
        args = list(sys.argv[1:] if args is None else args)
        # "--gpu_ids -1,-1" (two CPU shards): argparse would read the value
        # as an option; bind it to its flag
        joined = []
        for a in args:
            if joined and joined[-1] == "--gpu_ids" and a.startswith("-"):
                joined[-1] = f"--gpu_ids={a}"
            else:
                joined.append(a)
        opt, unknown = self.parser.parse_known_args(joined)
        if unknown:
            print(f"[options] ignoring unknown flags: {unknown}")
        opt.is_train = self.is_train
        if opt.query_size and opt.query_size[0] == 0:
            opt.query_size = opt.kernel_size
        self.opt = opt
        return opt

    def save(self, opt):
        """Dump opt.txt into the experiment directory."""
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name or "default")
        os.makedirs(expr_dir, exist_ok=True)
        with open(os.path.join(expr_dir, "opt.txt"), "w") as f:
            f.write("------------ Options -------------\n")
            for k, v in sorted(vars(opt).items()):
                f.write(f"{k}: {v}\n")
            f.write("-------------- End ----------------\n")


class TrainOptions(BaseOptions):
    is_train = True


class TestOptions(BaseOptions):
    is_train = False


class EditOptions(BaseOptions):
    is_train = False


def devices_from_opt(opt):
    """--gpu_ids -> one torch.device an id: -1 the CPU, otherwise
    cuda:<id>. No probe of the machine: without a card the first CUDA
    allocation fails."""
    ids = [i.strip() for i in str(getattr(opt, "gpu_ids", "0")).split(",")
           if i.strip()]
    return [torch.device("cpu") if int(i) < 0 else torch.device("cuda", int(i))
            for i in ids or ["0"]]


def device_from_opt(opt) -> torch.device:
    """The first --gpu_ids device: the master, where a model lives."""
    return devices_from_opt(opt)[0]


def shard_counts(opt):
    """(ray shards, scene shards) the flags ask for; 0 for unsharded.
    --ray_shards -1 is one shard a --gpu_ids entry; a count of 1 (or a
    --scene_shards below 2) runs unsharded, as in the JAX package."""
    n_ray = int(getattr(opt, "ray_shards", 0) or 0)
    if n_ray == -1:
        n_ray = len(devices_from_opt(opt))
    n_scene = int(getattr(opt, "scene_shards", 0) or 0)
    if n_ray > 1 and n_scene:
        raise ValueError(
            "--ray_shards and --scene_shards are mutually exclusive "
            "(rays-DP replicates the scene; slab sharding splits it)")
    return (n_ray if n_ray > 1 else 0), (n_scene if n_scene > 1 else 0)


def shard_devices(opt, n: int):
    """The first n --gpu_ids devices, one a shard; fewer ids than shards
    raise (no path runs on fewer shards than asked)."""
    devs = devices_from_opt(opt)
    if len(devs) < n:
        raise ValueError(
            f"{n} shards need {n} --gpu_ids entries, one a shard (repeats "
            f"allowed: 0,0 puts two shards on card 0); got "
            f"--gpu_ids {getattr(opt, 'gpu_ids', '0')}")
    return devs[:n]


def _check_slice(opt):
    """Refuse, at startup, what the flags cannot run (both CLIs call it;
    configs_from_opt too): shards without a device each, both kinds of
    shards at once."""
    n_ray, n_scene = shard_counts(opt)
    if n_ray or n_scene:
        shard_devices(opt, n_ray or n_scene)
    for xyz_flag in ("agg_feat_xyz_mode", "agg_alpha_xyz_mode",
                     "agg_color_xyz_mode"):
        if str(getattr(opt, xyz_flag, "None")) != "None":
            raise NotImplementedError(
                f"--{xyz_flag} != None is not supported (unused by every "
                "reference config)")


def _broadcast_w(items, weights):
    """One weight for N loss items applies to all of them."""
    items, weights = tuple(items or ()), tuple(weights or ())
    if items and len(weights) == 1 and len(items) > 1:
        weights = weights * len(items)
    return items, weights[:len(items)]


def configs_from_opt(opt, device=None):
    """opt namespace -> (RenderConfig, TrainConfig, grid kwargs). `auto`
    flags resolve from `device` (default: --gpu_ids)."""
    from ..models.aggregator import AggregatorConfig
    from ..models.renderer import RenderConfig
    from ..models.train import TrainConfig

    if opt.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError("--compute_dtype must be float32 or bfloat16, "
                         f"got {opt.compute_dtype!r}")
    if opt.gather_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError("--gather_dtype must be float32/bfloat16/int8, "
                         f"got {opt.gather_dtype!r}")
    gr = getattr(opt, "gather_round", "nearest")
    if gr not in ("nearest", "stochastic"):
        raise ValueError(
            f"--gather_round must be nearest or stochastic, got {gr!r}")
    gv = getattr(opt, "gather_vjp", "scatter")
    if opt.gather_dtype == "int8" and gv != "scatter":
        raise ValueError(
            "--gather_dtype int8 carries its own transpose; it composes "
            f"only with --gather_vjp scatter (got {gv!r})")
    ad = int(getattr(opt, "attr_dedup", -1))
    if ad < -1:
        raise ValueError(f"--attr_dedup must be -1 (auto) or >= 0, got {ad}")
    fused = getattr(opt, "fused_mlp", "auto")
    if fused not in ("auto", "pallas", "none"):
        raise ValueError(f"--fused_mlp must be auto/pallas/none, got {fused!r}")
    fb = getattr(opt, "fused_bwd", "auto")
    if fb not in ("auto", "pallas", "xla"):
        raise ValueError(f"--fused_bwd must be auto/pallas/xla, got {fb!r}")
    knn = getattr(opt, "knn_mode", "auto")
    if knn not in ("auto", "exact", "approx", "fused"):
        raise ValueError(
            f"--knn_mode must be auto/exact/approx/fused, got {knn!r}")
    fc = getattr(opt, "fused_color", "auto")
    if fc not in ("auto", "on", "off"):
        raise ValueError(f"--fused_color must be auto/on/off, got {fc!r}")
    fm = getattr(opt, "fused_march", "auto")
    if fm not in ("auto", "on", "off"):
        raise ValueError(f"--fused_march must be auto/on/off, got {fm!r}")
    if gv not in ("scatter", "sorted", "f32", "spread", "raydedup",
                  "batchdedup"):
        raise ValueError("--gather_vjp must be scatter/sorted/f32/spread/"
                         f"raydedup/batchdedup, got {gv!r}")
    wam = getattr(opt, "which_agg_model", "viewmlp")
    if wam not in ("viewmlp", "viewmlp_yuze"):
        raise ValueError(
            f"--which_agg_model must be viewmlp or viewmlp_yuze, got {wam!r}")
    agg_variant = "yuze" if wam == "viewmlp_yuze" else "default"
    _check_slice(opt)

    cuda = torch.device(device if device is not None
                        else device_from_opt(opt)).type == "cuda"
    # "pallas" is the shared flag table's name for "force the fused kernel"
    fused_mlp = "cuda" if fused == "pallas" or (fused == "auto" and cuda) \
        else "none"
    # the fused backward (kernel K3) wherever the fused forward runs;
    # "xla" names the JAX package's recompute backward: here autograd of
    # the plain version
    fused_bwd = ("plain" if fb == "xla" else "cuda" if fb == "pallas"
                 else "cuda" if fused_mlp == "cuda" else "plain")
    if knn == "auto":
        knn = "fused" if cuda and opt.cache_dtype == "bfloat16" else "exact"

    agg = AggregatorConfig(
        point_features_dim=opt.point_features_dim,
        shading_feature_num=opt.shading_feature_num,
        shading_feature_mlp_layer1=opt.shading_feature_mlp_layer1,
        shading_feature_mlp_layer2=opt.shading_feature_mlp_layer2,
        shading_feature_mlp_layer2_bpnet=opt.shading_feature_mlp_layer2_bpnet,
        shading_feature_mlp_layer3=opt.shading_feature_mlp_layer3,
        # block4 and block_linear live in the yuze variant only (the flag
        # defaults layer4 1, linear 0 must not reach the default variant)
        shading_feature_mlp_layer4=(opt.shading_feature_mlp_layer4
                                    if agg_variant == "yuze" else 0),
        shading_feature_mlp_linear=(opt.shading_feature_mlp_linear
                                    if agg_variant == "yuze" else 0),
        agg_variant=agg_variant,
        predict_semantic=opt.predict_semantic,
        shading_alpha_mlp_layer=opt.shading_alpha_mlp_layer,
        shading_color_mlp_layer=opt.shading_color_mlp_layer,
        num_feat_freqs=opt.num_feat_freqs,
        dist_xyz_freq=opt.dist_xyz_freq,
        dist_xyz_deno=opt.dist_xyz_deno,
        num_viewdir_freqs=opt.num_viewdir_freqs,
        agg_dist_pers=opt.agg_dist_pers,
        agg_distance_kernel=opt.agg_distance_kernel,
        agg_intrp_order=opt.agg_intrp_order,
        agg_weight_norm=opt.agg_weight_norm,
        act_type=opt.act_type,
        act_super=opt.act_super,
        point_color_mode=str(opt.point_color_mode),
        point_dir_mode=str(opt.point_dir_mode),
        axis_weight=(tuple(opt.agg_axis_weight)
                     if opt.agg_axis_weight is not None else None),
        compute_dtype=opt.compute_dtype,
        fused_mlp=fused_mlp,
        fused_bwd=fused_bwd,
        # opt-in, as in the JAX package: K4 (colour head in the kernel) and
        # K5 (colour head and march in the kernel, eval renders)
        fused_color=(fc == "on"),
        fused_march=(fm == "on"),
    )
    cfg = RenderConfig(
        agg=agg,
        z_depth_dim=opt.z_depth_dim,
        SR=opt.SR, K=opt.K,
        vsize=tuple(opt.vsize),
        radius_limit_scale=opt.radius_limit_scale,
        which_ray_generation=opt.which_ray_generation,
        which_render_func=opt.which_render_func,
        which_blend_func=opt.which_blend_func,
        which_tonemap_func=opt.which_tonemap_func,
        raydist_mode_unit=opt.raydist_mode_unit,
        gather_dtype=opt.gather_dtype,
        gather_round=gr,
        gather_vjp=gv,
        gvjp_U=int(getattr(opt, "gvjp_U", 128)),
        gvjp_batch_U=int(getattr(opt, "gvjp_batch_U", 0)),
        knn_mode=knn,
        semantic_guidance=opt.semantic_guidance,
        domain_size=float(opt.domain_size),
        shpnt_jitter=opt.shpnt_jitter,
        # the reference emits depth when compute_depth OR any depth loss is
        # requested (neural_points_volumetric_model.py:211)
        compute_depth=int(bool(opt.compute_depth)
                          or bool(opt.depth_loss_items)),
    )
    depth_items, depth_w = _broadcast_w(opt.depth_loss_items,
                                        opt.depth_loss_weights)
    bg_items, bg_w = _broadcast_w(opt.bg_loss_items, opt.bg_loss_weights)
    l2_items, l2_w = _broadcast_w(opt.l2_size_loss_items,
                                  opt.l2_size_loss_weights)
    tcfg = TrainConfig(
        lr=opt.lr, plr=opt.plr, lr_policy=opt.lr_policy,
        lr_decay_iters=opt.lr_decay_iters, lr_decay_exp=opt.lr_decay_exp,
        niter=opt.niter, niter_decay=opt.niter_decay,
        alter_step=opt.alter_step,
        feat_grad=opt.feat_grad, conf_grad=opt.conf_grad,
        color_grad=opt.color_grad, dir_grad=opt.dir_grad,
        xyz_grad=opt.xyz_grad,
        color_loss_items=tuple(opt.color_loss_items or ()),
        color_loss_weights=tuple(opt.color_loss_weights or ()),
        zero_one_loss_items=tuple(opt.zero_one_loss_items or ()),
        zero_one_loss_weights=tuple(opt.zero_one_loss_weights or ()),
        depth_loss_items=depth_items, depth_loss_weights=depth_w,
        bg_loss_items=bg_items, bg_loss_weights=bg_w,
        l2_size_loss_items=l2_items, l2_size_loss_weights=l2_w,
        sparse_loss_weight=opt.sparse_loss_weight,
        zero_epsilon=opt.zero_epsilon,
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
    return cfg, tcfg, grid_kwargs
