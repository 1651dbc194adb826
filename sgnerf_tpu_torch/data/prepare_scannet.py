"""ScanNet preprocessing: .sens extraction + 3D mesh -> (coords,colors,labels)
(the port's copy of `sgnerf_tpu/data/prepare_scannet.py`).

    python -m sgnerf_tpu_torch.data.prepare_scannet --scannet_path <scans>
        --output_path <out> [--export_label_images]

Reference prepare_data/:
  * SensorData.py: the ScanNet .sens v4 binary container (header: version u32,
    sensor-name string, 4x 4x4 f32 intrinsic/extrinsic, color/depth
    compression ids, dims, depth_shift, frame count; per frame: c2w 4x4 f32,
    two u64 timestamps, two u64 payload sizes, jpeg color bytes,
    zlib'd u16 depth);
  * prepare_2d_data.py: export color/depth/pose/label at 640x480 into the
    `exported/` layout the dataset consumes;
  * preprocess_3d_scannet.py:22-36: `_vh_clean_2.ply` + `.labels.ply` ->
    torch-saved (coords, colors in [-1,1], label20) `points.pth`.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

SCANNET20_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                 34, 36, 39]


def label_remapper_150() -> np.ndarray:
    remap = np.full(150, 255.0)
    for i, x in enumerate(SCANNET20_IDS):
        remap[x] = i
    return remap


class SensFrame:
    __slots__ = ("camera_to_world", "color_data", "depth_data")


class SensorData:
    """Minimal .sens v4 reader (lazy frame payloads)."""

    def __init__(self, filename: str):
        self.frames = []
        with open(filename, "rb") as f:
            version, = struct.unpack("I", f.read(4))
            assert version == 4, f"unsupported .sens version {version}"
            strlen, = struct.unpack("Q", f.read(8))
            self.sensor_name = f.read(strlen).decode("ascii", "replace")
            mats = np.frombuffer(f.read(4 * 16 * 4), np.float32).reshape(
                4, 4, 4)
            (self.intrinsic_color, self.extrinsic_color,
             self.intrinsic_depth, self.extrinsic_depth) = mats
            self.color_compression, = struct.unpack("i", f.read(4))
            self.depth_compression, = struct.unpack("i", f.read(4))
            (self.color_width, self.color_height, self.depth_width,
             self.depth_height) = struct.unpack("4I", f.read(16))
            self.depth_shift, = struct.unpack("f", f.read(4))
            num_frames, = struct.unpack("Q", f.read(8))
            for _ in range(num_frames):
                fr = SensFrame()
                fr.camera_to_world = np.frombuffer(
                    f.read(64), np.float32).reshape(4, 4).copy()
                f.read(16)  # timestamps
                csz, dsz = struct.unpack("QQ", f.read(16))
                fr.color_data = f.read(csz)
                fr.depth_data = f.read(dsz)
                self.frames.append(fr)

    def decode_color(self, i: int) -> np.ndarray:
        from PIL import Image
        with Image.open(io.BytesIO(self.frames[i].color_data)) as im:
            return np.asarray(im.convert("RGB"))

    def decode_depth(self, i: int) -> np.ndarray:
        raw = zlib.decompress(self.frames[i].depth_data)
        return np.frombuffer(raw, np.uint16).reshape(
            self.depth_height, self.depth_width)

    # ------------------------------------------------------------- exporters

    def export(self, out_dir: str, image_size: Tuple[int, int] = (480, 640),
               frame_skip: int = 1):
        """Write the `exported/{color,depth,pose,intrinsic}` layout."""
        from PIL import Image
        for sub in ("color", "depth", "pose", "intrinsic"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        H, W = image_size
        for i in range(0, len(self.frames), frame_skip):
            color = Image.fromarray(self.decode_color(i)).resize(
                (W, H), Image.NEAREST)
            color.save(os.path.join(out_dir, "color", f"{i}.jpg"))
            depth = Image.fromarray(self.decode_depth(i))
            depth.save(os.path.join(out_dir, "depth", f"{i}.png"))
            np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"),
                       self.frames[i].camera_to_world, fmt="%f")
        # intrinsics rescaled to the export size
        intr = self.intrinsic_color.copy()
        intr[0] *= W / self.color_width
        intr[1] *= H / self.color_height
        np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_color.txt"),
                   intr, fmt="%f")
        np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_depth.txt"),
                   self.intrinsic_depth, fmt="%f")


def read_label_mapping(tsv_path: str, label_from: str = "id",
                       label_to: str = "nyu40id") -> dict:
    """Parse `scannetv2-labels.combined.tsv` into {label_from: label_to}.

    Mirrors prepare_2d_data.py's util.read_label_mapping use (reference
    prepare_2d_data.py:73) and mapping_labels.py:13-21 (column 0 = id,
    column 4 = nyu40id; header row skipped; 0 maps to 0)."""
    import csv
    mapping = {0: 0}
    with open(tsv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                mapping[int(row[label_from])] = int(row[label_to])
            except (KeyError, TypeError, ValueError):
                continue          # rows with empty target ids are dropped
    return mapping


def map_label_image(image: np.ndarray, mapping: dict) -> np.ndarray:
    """Raw ScanNet label ids -> mapped (nyu40) uint8 image
    (reference prepare_2d_data.py:61-66). Unmapped ids become 0
    (unannotated) rather than passing through out of range."""
    image = np.asarray(image, np.int64)
    lut = np.zeros(max(int(image.max()) + 1, max(mapping) + 1), np.uint8)
    for k, v in mapping.items():
        lut[k] = v
    return lut[image]


def export_label_images(label_dir: str, out_dir: str, tsv_path: str,
                        frame_skip: int = 1,
                        image_size: Optional[Tuple[int, int]] = None):
    """`scene*/label-filt/*.png` (raw ids) -> `exported/label/{i}.png`
    (nyu40 uint8), the layout `scannet_ft_dataset` consumes for
    semantic-guided training (reference prepare_2d_data.py:115-126; the
    reference keeps the original resolution — pass image_size=(H, W) to
    resize with NEAREST like its commented-out sktf.resize order=0)."""
    from PIL import Image
    mapping = read_label_mapping(tsv_path)
    os.makedirs(out_dir, exist_ok=True)
    frames = sorted(int(os.path.splitext(n)[0])
                    for n in os.listdir(label_dir) if n.endswith(".png"))
    written = []
    for i in frames:
        if i % frame_skip:
            continue
        with Image.open(os.path.join(label_dir, f"{i}.png")) as im:
            raw = np.asarray(im.convert(mode="I"))
        mapped = Image.fromarray(map_label_image(raw, mapping))
        if image_size is not None:
            H, W = image_size
            mapped = mapped.resize((W, H), Image.NEAREST)
        mapped.save(os.path.join(out_dir, f"{i}.png"))
        written.append(i)
    return written


def preprocess_3d(mesh_ply: str, labels_ply: Optional[str],
                  out_pth: str):
    """`_vh_clean_2.ply` (+ `.labels.ply`) -> points.pth tuple
    (coords, colors in [-1,1], label20)."""
    from ..utils.ply import read_ply
    d = read_ply(mesh_ply)
    coords = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float64)
    colors = np.stack([d["red"], d["green"], d["blue"]],
                      -1).astype(np.float64) / 127.5 - 1.0
    if labels_ply and os.path.exists(labels_ply):
        dl = read_ply(labels_ply)
        labels = label_remapper_150()[
            np.clip(np.asarray(dl["label"], np.int64), 0, 149)]
    else:
        labels = np.full(len(coords), 255.0)
    import torch
    torch.save((coords, colors, labels), out_pth)
    return coords, colors, labels


def main(argv=None):
    """CLI mirroring the reference's prepare_2d_data.py flags: walk
    `--scannet_path` for scene dirs with `<scene>.sens` (+ `label-filt/`
    when `--export_label_images`), write the `exported/`-style tree under
    `--output_path/<scene>/` that scannet_ft_dataset consumes."""
    import argparse
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--scannet_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--export_label_images", action="store_true")
    p.add_argument("--label_type", default="label-filt")
    p.add_argument("--frame_skip", type=int, default=1)
    p.add_argument("--label_map_file",
                   default="scannetv2-labels.combined.tsv")
    p.add_argument("--output_image_width", type=int, default=640)
    p.add_argument("--output_image_height", type=int, default=480)
    opt = p.parse_args(argv)
    scenes = sorted(d for d in os.listdir(opt.scannet_path)
                    if os.path.isdir(os.path.join(opt.scannet_path, d)))
    print(f"Found {len(scenes)} scenes")
    for i, scene in enumerate(scenes):
        out = os.path.join(opt.output_path, scene)
        print(f"[ {i + 1} | {len(scenes)} ] {scene}", flush=True)
        sd = SensorData(os.path.join(opt.scannet_path, scene,
                                     scene + ".sens"))
        sd.export(out, image_size=(opt.output_image_height,
                                   opt.output_image_width),
                  frame_skip=opt.frame_skip)
        if opt.export_label_images:
            label_dir = os.path.join(opt.scannet_path, scene, opt.label_type)
            if not os.path.isdir(label_dir):
                raise SystemExit(f"ERROR: --export_label_images but "
                                 f"{label_dir} does not exist")
            export_label_images(label_dir, os.path.join(out, "label"),
                                opt.label_map_file,
                                frame_skip=opt.frame_skip)


if __name__ == "__main__":
    main()
