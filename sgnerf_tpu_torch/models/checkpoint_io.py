"""Checkpoint I/O: the native format and the reference PyTorch `.pth`.

The port's copy of what it uses from `sgnerf_tpu/models/checkpoint_io.py`
(numpy and torch only): the native format (`save_native`/`load_native`, an
.npz of flattened key paths plus a JSON sidecar of counters, readable by
either package), the reference state-dict import/export and the mode-0
attribute unpacking, the BPNet converter (`convert_bpnet_checkpoint`) and
the companion {iter}_semanticEmbedding.pth, and the official MVSNet
converter (`convert_official_mvsnet_checkpoint`, the `--pre_d_est` file).

Reference checkpoint layout ({iter}_net_ray_marching.pth, a flat
state_dict of NeuralPointsRayMarching): neural_points.xyz [N,3],
neural_points.points_{embeding,conf,dir,color} [1,N,C],
neural_points.points_feats [N,3], optional points_label and Rw2c, and
aggregator.<block>.<2i>.weight/bias of torch Sequentials (Linear at even
indices, weight [out,in]; ours is [in,out]). A separate {iter}_states.pth
holds counters (epoch/total_steps/best_PSNR).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}/{i}", v, out)
    elif tree is None:
        pass
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    def listify(d):
        if not isinstance(d, dict):
            return d
        keys = list(d.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(d[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in d.items()}

    return listify(root)


def save_native(path: str, tree: Any, meta: Optional[Dict] = None):
    """The tree as an uncompressed .npz of flattened key paths (np.load
    reads it as it reads the JAX package's compressed ones), the counters
    in a JSON sidecar. Uncompressed: the float rows hardly compress, and
    zlib over a 4.2M-point semantic cloud (~2.8 GB with the 20 label
    probabilities and the 96-d embedding a point) took minutes a save,
    most of a short semantic `train_ft` run."""
    flat: Dict[str, np.ndarray] = {}
    _flatten("", tree, flat)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_native(path: str) -> Tuple[Any, Optional[Dict]]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return _unflatten(flat), meta


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def _seq_layers(sd: Dict[str, np.ndarray], prefix: str):
    """Collect Linear layers of a torch Sequential in index order."""
    pat = re.compile(rf"^{re.escape(prefix)}\.(\d+)\.weight$")
    idxs = sorted(int(m.group(1)) for k in sd if (m := pat.match(k)))
    return [{"w": np.ascontiguousarray(sd[f"{prefix}.{i}.weight"].T.copy()),
             "b": sd[f"{prefix}.{i}.bias"].copy()} for i in idxs]


def convert_reference_checkpoint(sd: Dict[str, np.ndarray]):
    """Split a reference state dict into (aggregator params, point arrays).

    Returns (params, points) where points has keys xyz/embedding/conf/dir/
    color/feats/label/Rw2c (None when absent)."""
    params: Dict[str, Any] = {}
    for block in ("block1", "block2", "block2_bpnet", "block3",
                  "block4", "block_linear",     # yuze aggregator variant
                  "alpha_branch", "color_branch"):
        layers = _seq_layers(sd, f"aggregator.{block}")
        if layers:
            params[block] = layers

    def squeeze(name):
        a = sd.get(name)
        if a is None:
            return None
        a = np.asarray(a, np.float32)
        return a[0] if a.ndim == 3 and a.shape[0] == 1 else a

    points = {
        "xyz": sd.get("neural_points.xyz"),
        "embedding": squeeze("neural_points.points_embeding"),
        "conf": squeeze("neural_points.points_conf"),
        "dir": squeeze("neural_points.points_dir"),
        "color": squeeze("neural_points.points_color"),
        "feats": sd.get("neural_points.points_feats"),
        "label": sd.get("neural_points.points_label"),
        "Rw2c": sd.get("neural_points.Rw2c"),
    }
    return params, points


def export_reference_checkpoint(params: Dict[str, Any], points: Dict[str, Any],
                                path: str):
    """Write a reference-compatible .pth so reference tooling (Editor, eval)
    can consume our checkpoints."""
    sd = {}
    for block, layers in params.items():
        for li, layer in enumerate(layers):
            sd[f"aggregator.{block}.{2 * li}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(layer["w"]).T))
            sd[f"aggregator.{block}.{2 * li}.bias"] = torch.from_numpy(
                np.asarray(layer["b"]))

    def unsqueeze(a):
        return torch.from_numpy(np.asarray(a, np.float32))[None]

    sd["neural_points.xyz"] = torch.from_numpy(
        np.asarray(points["xyz"], np.float32))
    for src, dst in (("embedding", "points_embeding"), ("conf", "points_conf"),
                     ("dir", "points_dir"), ("color", "points_color")):
        if points.get(src) is not None:
            sd[f"neural_points.{dst}"] = unsqueeze(points[src])
    if points.get("feats") is not None:
        sd["neural_points.points_feats"] = torch.from_numpy(
            np.asarray(points["feats"], np.float32))
    if points.get("Rw2c") is not None:
        sd["neural_points.Rw2c"] = torch.from_numpy(
            np.asarray(points["Rw2c"], np.float32))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(sd, path)


def unpack_embedding_modes(points: Dict[str, Any], point_conf_mode: str = "1",
                           point_dir_mode: str = "1",
                           point_color_mode: str = "1",
                           point_features_dim: int = 32) -> Dict[str, Any]:
    """Undo mode-0 attribute packing: with point_{conf,dir,color}_mode "0",
    the attribute was concatenated into points_embeding instead of stored
    separately (reference set_points, neural_points.py:594-620; packing order
    conf -> dir -> color, each PREPENDED, so the final leading layout is
    [color(3), dir(3), conf(1), features])."""
    emb = points.get("embedding")
    if emb is None:
        return points
    out = dict(points)
    emb = np.asarray(emb)
    if "0" in str(point_color_mode) and out.get("color") is None \
            and emb.shape[-1] > point_features_dim:
        out["color"], emb = emb[:, :3], emb[:, 3:]
    if "0" in str(point_dir_mode) and out.get("dir") is None \
            and emb.shape[-1] > point_features_dim:
        out["dir"], emb = emb[:, :3], emb[:, 3:]
    if "0" in str(point_conf_mode) and out.get("conf") is None \
            and emb.shape[-1] > point_features_dim:
        out["conf"], emb = emb[:, :1], emb[:, 1:]
    out["embedding"] = emb
    return out


def load_reference_states(path: str) -> Dict[str, Any]:
    """Read the companion {iter}_states.pth (epoch/total_steps/best_PSNR —
    run/train_ft.py:613-648)."""
    st = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for k, v in dict(st).items():
        try:
            out[k] = float(v) if hasattr(v, "item") else v
        except (TypeError, ValueError, RuntimeError):   # non-scalar tensors
            out[k] = v
    return out


# ------------------------------------------------------ BPNet .pth.tar import

def _me_kernel(a):
    """MinkowskiEngine conv kernel (K^3, ci, co) -> the port's (K^3, ci, co).

    ME enumerates a cubic kernel's offsets with the first spatial axis
    fastest, ops/sparse.py `_offsets` with the last: the rows are permuted
    between the two (an involution). kernel_size 1 convs (block
    downsamples, cls_3d) are stored 2-D (ci, co) by ME: lifted to
    (1, ci, co)."""
    a = np.asarray(a)
    if a.ndim == 2:
        return a[None]
    if a.ndim != 3:
        return a
    k3 = a.shape[0]
    k = round(k3 ** (1 / 3))
    if k ** 3 != k3:
        return a
    return a[np.arange(k3).reshape(k, k, k).transpose(2, 1, 0).reshape(-1)]


def _bn_t(sd, p):
    return {k: sd[f"{p}.{k}"] for k in ("weight", "bias", "running_mean",
                                        "running_var")}


def convert_bpnet_checkpoint(path_or_sd, classes: int = 20):
    """A reference BPNet checkpoint (the --bpnetweight file, e.g.
    bpnet_5cm.pth.tar, a {'state_dict': ...} with module. prefixes) or its
    state dict of numpy arrays -> the port's BPNet tree (models/bpnet),
    float32 tensors on the CPU: the 2D ResUNet-34 (torch's conv layout, as
    stored), the MinkUNet18A stages and the four Linking modules
    (reference bpnet.py:212-245 naming)."""
    if isinstance(path_or_sd, str):
        raw = torch.load(path_or_sd, map_location="cpu", weights_only=False)
        sd = raw.get("state_dict", raw.get("model", raw))
        sd = {(k[len("module."):] if k.startswith("module.") else k):
              (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
              for k, v in sd.items()}
    else:
        sd = path_or_sd

    def block2d(prefix):
        b = {"conv1": sd[f"{prefix}.conv1.weight"],
             "bn1": _bn_t(sd, f"{prefix}.bn1"),
             "conv2": sd[f"{prefix}.conv2.weight"],
             "bn2": _bn_t(sd, f"{prefix}.bn2")}
        if f"{prefix}.downsample.0.weight" in sd:
            b["downsample"] = {"conv": sd[f"{prefix}.downsample.0.weight"],
                               "bn": _bn_t(sd, f"{prefix}.downsample.1")}
        return b

    def indexed(prefix, first_key, make):
        out, i = [], 0
        while f"{prefix}.{i}.{first_key}" in sd:
            out.append(make(f"{prefix}.{i}"))
            i += 1
        return out

    u2 = {"conv1": sd["layer0_2d.0.weight"], "bn1": _bn_t(sd, "layer0_2d.1")}
    for i in (1, 2, 3, 4):
        u2[f"layer{i}"] = indexed(f"layer{i}_2d", "conv1.weight", block2d)
    for j in (4, 3, 2):
        u2[f"up{j}"] = {"conv": sd[f"up{j}_2d.0.weight"],
                        "bn": _bn_t(sd, f"up{j}_2d.1")}
        u2[f"delayer{j}"] = indexed(f"delayer{j}_2d", "conv1.weight",
                                    block2d)
    u2["cls"] = {"conv1": sd["cls_2d.0.weight"], "bn": _bn_t(sd, "cls_2d.1"),
                 "conv2": sd["cls_2d.3.weight"], "bias2": sd["cls_2d.3.bias"]}

    def mink_block(prefix):
        b = {"conv1": _me_kernel(sd[f"{prefix}.conv1.kernel"]),
             "bn1": _bn_t(sd, f"{prefix}.norm1.bn"),
             "conv2": _me_kernel(sd[f"{prefix}.conv2.kernel"]),
             "bn2": _bn_t(sd, f"{prefix}.norm2.bn")}
        if f"{prefix}.downsample.0.kernel" in sd:
            b["downsample"] = {
                "conv": _me_kernel(sd[f"{prefix}.downsample.0.kernel"]),
                "bn": _bn_t(sd, f"{prefix}.downsample.1.bn")}
        return b

    def mink_blocks(prefix):
        return indexed(prefix, "conv1.kernel", mink_block)

    u3 = {"conv0p1s1": _me_kernel(sd["layer0_3d.0.kernel"]),
          "bn0": _bn_t(sd, "layer0_3d.1.bn")}
    for i in range(1, 5):
        u3[f"conv{i}"] = _me_kernel(sd[f"layer{i}_3d.0.kernel"])
        u3[f"bn{i}"] = _bn_t(sd, f"layer{i}_3d.1.bn")
        u3[f"block{i}"] = mink_blocks(f"layer{i}_3d.3")
    u3["convtr4"] = _me_kernel(sd["layer5_3d.0.kernel"])
    u3["bntr4"] = _bn_t(sd, "layer5_3d.1.bn")
    for li, bname, tname in ((6, "block5", "convtr5"), (7, "block6", "convtr6"),
                             (8, "block7", "convtr7")):
        u3[bname] = mink_blocks(f"layer{li}_3d.0")
        u3[tname] = _me_kernel(sd[f"layer{li}_3d.1.kernel"])
        u3[f"bntr{tname[-1]}"] = _bn_t(sd, f"layer{li}_3d.2.bn")
    u3["block8"] = mink_blocks("layer9_3d")
    u3["final"] = {"kernel": _me_kernel(sd["cls_3d.kernel"]),
                   "bias": sd.get("cls_3d.bias",
                                  np.zeros(classes, np.float32))}

    out = {"unet2d": u2, "unet3d": u3}
    for lv in ("p5", "p4", "p3", "p2"):
        p = f"linker_{lv}"
        out[p] = {
            "view_fusion": {
                "conv1": _me_kernel(sd[f"{p}.view_fusion.0.kernel"]),
                "bn1": _bn_t(sd, f"{p}.view_fusion.1.bn"),
                "conv2": _me_kernel(sd[f"{p}.view_fusion.3.kernel"]),
                "bn2": _bn_t(sd, f"{p}.view_fusion.4.bn")},
            "fuseTo3d": {"conv": _me_kernel(sd[f"{p}.fuseTo3d.0.kernel"]),
                         "bn": _bn_t(sd, f"{p}.fuseTo3d.1.bn")},
            "view_sep": {"conv": _me_kernel(sd[f"{p}.view_sep.0.kernel"]),
                         "bn": _bn_t(sd, f"{p}.view_sep.1.bn")},
            "fuseTo2d": {"conv": sd[f"{p}.fuseTo2d.0.weight"],
                         "bn": _bn_t(sd, f"{p}.fuseTo2d.1")},
        }

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tensors(v) for v in t]
        return torch.tensor(np.ascontiguousarray(np.asarray(t, np.float32)))
    return tensors(out)


# ------------------------------------------ the companion semantic embedding

def save_semantic_embedding(sem: np.ndarray, path: str) -> bool:
    """Write the (N,96) BPNet point embedding as the reference's
    {it}_semanticEmbedding.pth, a (1,N,96) tensor (reference
    saveSemanticEmbedding, neural_points_volumetric_model.py:674-681).
    Nothing is written when it is all zeros (no refresh ran)."""
    sem = np.asarray(sem, np.float32)
    if sem.size == 0 or np.abs(sem).max() == 0:
        return False
    torch.save(torch.from_numpy(sem[None].copy()), path)
    return True


def load_semantic_embedding(path: str) -> np.ndarray:
    """{it}_semanticEmbedding.pth -> (N,96) float32."""
    sem = torch.load(path, map_location="cpu", weights_only=False)
    sem = np.asarray(sem.detach().cpu() if hasattr(sem, "detach") else sem,
                     np.float32)
    return sem[0] if sem.ndim == 3 else sem


# -------------------------------------------------- MVSNet .ckpt conversion

def convert_official_mvsnet_checkpoint(path: str, device="cpu"):
    """The reference's pretrained MVSNet checkpoint (`--pre_d_est`, e.g.
    MVSNet/model_000014.ckpt, a {'model': state_dict} with `module.`
    prefixes, mvs_points_model.py:66-74) -> the port's `official` tree:
    torch's own conv layouts (OIHW, OIDHW, ConvTranspose3d's ci-first), BN
    weights and statistics, float32 on `device`."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("model", raw)
    flat = {(k[len("module."):] if k.startswith("module.") else k):
            torch.as_tensor(v).detach().to(torch.float32)
            for k, v in sd.items()}

    def t(key):
        return flat[key].clone().to(device)

    def bn(prefix):
        return {k: t(f"{prefix}.{k}")
                for k in ("weight", "bias", "running_mean", "running_var")}

    def cbr(prefix):
        # reference ConvBnReLU: .conv (Conv, no bias) + .bn
        return {"conv": {"weight": t(f"{prefix}.conv.weight")},
                "bn": bn(f"{prefix}.bn")}

    feature = {f"conv{i}": cbr(f"feature.conv{i}") for i in range(7)}
    feature["feature"] = {"weight": t("feature.feature.weight"),
                          "bias": t("feature.feature.bias")}
    cr = "cost_regularization"
    cost = {f"conv{i}": cbr(f"{cr}.conv{i}") for i in range(7)}
    for i in (7, 9, 11):
        cost[f"conv{i}"] = {"0": {"weight": t(f"{cr}.conv{i}.0.weight")},
                            "1": bn(f"{cr}.conv{i}.1")}
    cost["prob"] = {"weight": t(f"{cr}.prob.weight"),
                    "bias": t(f"{cr}.prob.bias")}
    return {"feature": feature, "cost_regularization": cost}
