"""Minimal PLY point-cloud I/O (ascii + binary_little_endian), numpy-only.

Replaces the reference's open3d/plyfile dependency for:
  * `exported/pcd.ply` scene clouds (data/scannet_ft_dataset.py:463-495)
  * the Editor's neural-point ply schema with per-point embeddings
    (Editor/pointcloud.py:82-191: x,y,z,r,g,b,dirx..z,conf,label,embeding0..31)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the `vertex` element into a dict of 1-D property arrays."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        n_vertex = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property on vertex unsupported")
                props.append((parts[2], _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break

        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex)
            data = data.reshape(n_vertex, len(props))
            return {name: data[:, i].astype(dt)
                    for i, (name, dt) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + d) for name, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            return {name: np.ascontiguousarray(raw[name]) for name, _ in props}
        else:
            raise ValueError(f"unsupported ply format {fmt}")


def write_ply(path: str, props: Dict[str, np.ndarray], binary: bool = True):
    names = list(props.keys())
    n = len(next(iter(props.values())))
    inv = {v: k for k, v in _PLY_DTYPES.items()}
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}"]
    cols = []
    for name in names:
        a = np.asarray(props[name])
        code = a.dtype.str.lstrip("<>|=")
        header.append(f"property {inv[code]} {name}")
        cols.append(a)
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            rec = np.empty(n, dtype=np.dtype(
                [(name, "<" + np.asarray(props[name]).dtype.str.lstrip("<>|="))
                 for name in names]))
            for name in names:
                rec[name] = props[name]
            f.write(rec.tobytes())
        else:
            mat = np.column_stack([np.asarray(c, np.float64) for c in cols])
            np.savetxt(f, mat, fmt="%.8g")


def read_xyz_rgb(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    rgb = None
    if "red" in d:
        rgb = np.stack([d["red"], d["green"], d["blue"]], -1).astype(np.float32)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    return xyz, rgb
