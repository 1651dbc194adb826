"""The editor's neural-point-cloud container with checkpoint and ply round
trips (the port's copy of `sgnerf_tpu/editor/pointcloud.py`; reference
Editor/pointcloud.py:57-196).

The ply schema carries every neural attribute as a vertex property:
  x,y,z, red,green,blue (float), conf, dirx..z, embeding0..F-1, label (uint8)
so external tools (meshlab) can select and edit points and the selection
maps back to neural points. `to_checkpoint` writes the edited cloud back
into a reference-format .pth (reference checkpoints_controller.py:31-55).
Host arrays only: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..models.checkpoint_io import (convert_reference_checkpoint,
                                    export_reference_checkpoint, load_native,
                                    load_torch_state_dict)
from ..utils.ply import read_ply, write_ply


@dataclasses.dataclass
class NeuralPointCloudEdit:
    xyz: np.ndarray                      # (N,3)
    embedding: np.ndarray                # (N,F)
    conf: np.ndarray                     # (N,)
    dir: np.ndarray                      # (N,3)
    color: np.ndarray                    # (N,3)
    label: np.ndarray                    # (N,)
    params: Optional[dict] = None        # aggregator MLP weights (passed on)

    @property
    def n(self):
        return len(self.xyz)

    # ------------------------------------------------------------ checkpoints

    @classmethod
    def from_checkpoint(cls, path: str) -> "NeuralPointCloudEdit":
        """The live points of a reference .pth or a native .npz."""
        if path.endswith(".pth"):
            params, pts = convert_reference_checkpoint(
                load_torch_state_dict(path))
            n = len(pts["xyz"])
            return cls(
                xyz=np.asarray(pts["xyz"], np.float32),
                embedding=np.asarray(pts["embedding"], np.float32),
                conf=np.asarray(pts["conf"], np.float32).reshape(n),
                dir=np.asarray(pts["dir"], np.float32),
                color=np.asarray(pts["color"], np.float32),
                label=(np.asarray(pts["label"]).reshape(n)
                       if pts.get("label") is not None
                       else np.zeros(n, np.int32)),
                params=params)
        tree, _ = load_native(path)
        c = tree["cloud"]
        act = np.asarray(c["active"]).astype(bool)
        # a cloud saved without labels has none (label 0), as from a .pth
        label = c.get("label", np.zeros(len(act), np.int32))
        return cls(
            xyz=np.asarray(c["xyz"])[act],
            embedding=np.asarray(c["embedding"])[act],
            conf=np.asarray(c["conf"])[act].reshape(-1),
            dir=np.asarray(c["dir"])[act],
            color=np.asarray(c["color"])[act],
            label=np.asarray(label)[act],
            params=tree.get("params"))

    def to_checkpoint(self, path: str):
        pts = {"xyz": self.xyz, "embedding": self.embedding,
               "conf": self.conf.reshape(-1, 1), "dir": self.dir,
               "color": self.color, "feats": self.color * 255.0,
               "Rw2c": np.eye(3, dtype=np.float32)}
        export_reference_checkpoint(self.params or {}, pts, path)

    # -------------------------------------------------------------------- ply

    def save_as_ply(self, path: str):
        props = {
            "x": self.xyz[:, 0], "y": self.xyz[:, 1], "z": self.xyz[:, 2],
            "red": self.color[:, 0].astype(np.float32),
            "green": self.color[:, 1].astype(np.float32),
            "blue": self.color[:, 2].astype(np.float32),
            "conf": self.conf.astype(np.float32),
            "dirx": self.dir[:, 0], "diry": self.dir[:, 1],
            "dirz": self.dir[:, 2],
        }
        for i in range(self.embedding.shape[1]):
            props[f"embeding{i}"] = self.embedding[:, i]
        props["label"] = self.label.astype(np.uint8)
        write_ply(path, props)

    @classmethod
    def load_from_ply(cls, path: str) -> "NeuralPointCloudEdit":
        d = read_ply(path)
        F = sum(1 for k in d if k.startswith("embeding"))
        emb = np.stack([d[f"embeding{i}"] for i in range(F)], -1)
        return cls(
            xyz=np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32),
            embedding=emb.astype(np.float32),
            conf=np.asarray(d["conf"], np.float32),
            dir=np.stack([d["dirx"], d["diry"], d["dirz"]],
                         -1).astype(np.float32),
            color=np.stack([d["red"], d["green"], d["blue"]],
                           -1).astype(np.float32),
            label=np.asarray(d["label"], np.int32))

    def select(self, mask: np.ndarray) -> "NeuralPointCloudEdit":
        """The rows of a bool mask or an index array."""
        return NeuralPointCloudEdit(
            xyz=self.xyz[mask], embedding=self.embedding[mask],
            conf=self.conf[mask], dir=self.dir[mask],
            color=self.color[mask], label=self.label[mask],
            params=self.params)
