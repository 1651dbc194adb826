"""Dataset subsampling into sparse-view variants (the port's copy of
`sgnerf_tpu/data/resample.py`).

Reference: resample/sampledata.py: copy every n-th frame of
an exported ScanNet scene into a new scene directory (sparse-view training
sets), renumbering frames contiguously.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional


def resample_scene(src_scene: str, dst_scene: str, step: int,
                   max_frames: Optional[int] = None):
    """src/dst are scene dirs containing `exported/`."""
    src = os.path.join(src_scene, "exported")
    dst = os.path.join(dst_scene, "exported")
    for sub in ("color", "depth", "pose", "label"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    shutil.copytree(os.path.join(src, "intrinsic"),
                    os.path.join(dst, "intrinsic"), dirs_exist_ok=True)
    for f in ("pcd.ply", "points.pth", "blur_list.txt"):
        p = os.path.join(src, f)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dst, f))

    n = len([f for f in os.listdir(os.path.join(src, "color"))
             if f.endswith(".jpg")])
    ids = list(range(0, n, step))
    if max_frames:
        ids = ids[:max_frames]
    exts = {"color": ".jpg", "depth": ".png", "pose": ".txt",
            "label": ".png"}
    kept = 0
    for new_id, old_id in enumerate(ids):
        ok = True
        for sub, ext in exts.items():
            sp = os.path.join(src, sub, f"{old_id}{ext}")
            if not os.path.exists(sp):
                if sub == "color":
                    ok = False
                continue
            shutil.copy(sp, os.path.join(dst, sub, f"{new_id}{ext}"))
        kept += ok
    print(f"resampled {kept} frames (step {step}) into {dst_scene}")
    return kept


def main(argv=None):
    """python -m sgnerf_tpu_torch.data.resample --src <scene> --dst <scene>
    [--step 5] [--max_frames N]"""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--step", type=int, default=5)
    ap.add_argument("--max_frames", type=int, default=None)
    a = ap.parse_args(argv)
    return resample_scene(a.src, a.dst, a.step, a.max_frames)


if __name__ == "__main__":
    main()
