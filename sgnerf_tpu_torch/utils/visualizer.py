"""Visualizer: image dumps, loss accumulation/printing, video generation.

The port's copy of `sgnerf_tpu/utils/visualizer.py` (reference
utils/visualizer.py:39-197): `step-%04d-{name}.png` image naming,
accumulated loss averages printed every print_freq to stdout and appended to
`{ckpt}/{name}/print/loss`, video generation (imageio, else a GIF by PIL).
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.image_dir = os.path.join(opt.checkpoints_dir, opt.name or "default",
                                      "images")
        self.print_dir = os.path.join(opt.checkpoints_dir, opt.name or "default",
                                      "print")
        os.makedirs(self.image_dir, exist_ok=True)
        os.makedirs(self.print_dir, exist_ok=True)
        self.log_path = os.path.join(self.print_dir, "loss")
        self.acc_iterations = 0
        self.acc_losses: Dict[str, float] = defaultdict(float)
        self.start_time = time.time()
        self.tb = None
        if getattr(opt, "show_tensorboard", 0):
            # reference: tensorboardX SummaryWriter (visualizer.py:48-52);
            # torch's writer is the baked-in equivalent. Degrade silently to
            # file logging if the tensorboard package is absent.
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(
                    log_dir=os.path.join(opt.checkpoints_dir,
                                         opt.name or "default", "tb"))
            except ImportError:
                self.tb = None

    # ------------------------------------------------------------------ losses

    def accumulate_losses(self, losses: Dict[str, float]):
        """Accepts host floats or device scalars. Device scalars are not
        synchronised here (that would stall every step on the device); they
        sum on the device and convert at print time."""
        self.acc_iterations += 1
        for k, v in losses.items():
            self.acc_losses[k] += v

    def print_losses(self, total_steps: int):
        if self.acc_iterations == 0:
            return
        msg = f"step: {total_steps}, "
        msg += ", ".join(f"{k}: {float(v) / self.acc_iterations:.6f}"
                         for k, v in sorted(self.acc_losses.items()))
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        if self.tb is not None:
            for k, v in self.acc_losses.items():
                self.tb.add_scalar(f"loss/{k}",
                                   float(v) / self.acc_iterations,
                                   total_steps)

    def reset(self):
        self.acc_iterations = 0
        self.acc_losses = defaultdict(float)

    # ------------------------------------------------------------------ images

    def save_image(self, img: np.ndarray, path: str):
        from PIL import Image
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(img).save(path)

    def display_current_results(self, visuals: Dict[str, np.ndarray],
                                step: int, subdir: Optional[str] = None):
        out_dir = (os.path.join(self.image_dir, subdir) if subdir
                   else self.image_dir)
        os.makedirs(out_dir, exist_ok=True)
        for name, img in visuals.items():
            if img is None:
                continue
            self.save_image(np.asarray(img),
                            os.path.join(out_dir, f"step-{step:04d}-{name}.png"))

    def save_neural_points(self, step, xyz: np.ndarray, colors=None,
                           save_ref=False):
        out_dir = os.path.join(self.image_dir, "pointclouds")
        os.makedirs(out_dir, exist_ok=True)
        data = np.asarray(xyz).reshape(-1, 3)
        if colors is not None:
            data = np.concatenate(
                [data, np.asarray(colors).reshape(len(data), -1)], axis=-1)
        np.savetxt(os.path.join(out_dir, f"step-{step}-pnts.txt"), data,
                   delimiter=";")

    # ------------------------------------------------------------------- video

    def gen_video(self, img_dir: str, pattern: str, out_path: str, fps: int = 24):
        """Frames matching `pattern` in img_dir -> out_path through imageio
        (mp4 with an ffmpeg backend); without imageio or its backend, a GIF
        beside it written by PIL (the reference writes .mov/.gif,
        visualizer.py:85-95)."""
        import re
        from PIL import Image
        files = sorted(
            (f for f in os.listdir(img_dir) if re.fullmatch(pattern, f)))
        if not files:
            print(f"gen_video: no frames matching {pattern} in {img_dir}")
            return
        frames = []
        for f in files:
            with Image.open(os.path.join(img_dir, f)) as im:
                frames.append(np.asarray(im.convert("RGB")))
        try:
            import imageio.v2 as imageio
            imageio.mimwrite(out_path, frames, fps=fps, quality=8)
        except (ImportError, RuntimeError, ValueError, OSError) as e:
            gif_path = os.path.splitext(out_path)[0] + ".gif"
            print(f"gen_video: {type(e).__name__} writing {out_path}; "
                  f"falling back to {gif_path}")
            gifs = [Image.fromarray(f) for f in frames]
            gifs[0].save(gif_path, save_all=True, append_images=gifs[1:],
                         duration=int(1000 / min(fps, 24)), loop=0)
            out_path = gif_path
        print(f"video written: {out_path} ({len(frames)} frames)")
