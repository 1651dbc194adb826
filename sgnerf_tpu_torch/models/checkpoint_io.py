"""Checkpoint I/O: the native format and the reference PyTorch `.pth`.

The port's copy of what it uses from `sgnerf_tpu/models/checkpoint_io.py`
(numpy and torch only): the native format (`save_native`/`load_native`, an
.npz of flattened key paths plus a JSON sidecar of counters, readable by
either package), the reference state-dict import/export and the mode-0
attribute unpacking. The MVS and BPNet converters come with their slices.

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
    flat: Dict[str, np.ndarray] = {}
    _flatten("", tree, flat)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)
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
