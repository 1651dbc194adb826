"""Traffic kind `eval_frames`: one client in a closed loop renders full
frames back to back through `SceneModel.render_image` (the path of
`run/test_ft.py` and `render_vid`), each from a new camera drawn from the
seed; a frame is complete when its colours are on the host.

The check: a sample of the frames completed in the window, drawn from the
seed, rendered again by the plain reference at the configuration's stated
precision from inputs regenerated from the seed; each pixel's gap is its
largest channel difference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, scene
from ..reference import pointnerf as ref_pn


class Driver:
    train = False

    def __init__(self, h):
        self.h = h
        self.cfg, self.tr = h.cfg, h.traffic
        self.sec = h.cfg["eval"]
        t = h.traffic
        self.ref = {**self.sec["ref"], "near": t["near"], "far": t["far"],
                    "bg_color": t["bg_color"]}

    # ------------------------------------------------------------ inputs
    def inputs(self):
        h, cfg = self.h, self.cfg
        sc = scene.room_scan(int(cfg["scene"]["layout"]),
                             int(cfg["scene"]["n_points"]), h.device)
        attrs = scene.point_attributes(sc, h.seed,
                                       int(cfg["widths"]["point_features"]))
        sem = None
        if self.ref["semantic"]:
            sem = scene.semantics(sc, h.seed, int(cfg["widths"]["classes"]),
                                  int(cfg["widths"]["semantic"]))
        params = program.mlp_weights(h.seed, cfg["mlps"], h.device)
        return sc, attrs, sem, params

    def item(self, pose):
        t = self.tr
        return scene.frame_item(pose[0], pose[1], self.dirs, t["near"],
                                t["far"], t["bg_color"])

    def setup(self):
        h, t = self.h, self.tr
        sc, attrs, sem, params = self.inputs()
        self.model, self.scene_build_s = program.build_model(
            self.sec["flags"], False, h.device, attrs, params, sem, h.workdir)
        del attrs, sem, params
        if h.fault is not None:
            h.fault(self.model)
        self.boxes = sc.boxes
        del sc
        self.dirs = scene.pixel_dirs(t["width"], t["height"], t["focal"])
        self.rays = t["width"] * t["height"]
        self.poses = scene.draw_poses(h.seed, 10, int(t["max_frames"]),
                                      self.boxes, t["wall_margin"],
                                      t["pitch"])
        warm = scene.draw_poses(h.seed, 11, 1, self.boxes, t["wall_margin"],
                                t["pitch"])[0]
        self.model.render_image(self.item(warm), chunk_rays=t["chunk_rays"])

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tick=None):
        t = self.tr
        self.cols, self.frame_s = [], []
        start = time.perf_counter()
        while True:
            it = self.item(self.poses[len(self.cols)])
            t0 = time.perf_counter()
            col = self.model.render_image(it, chunk_rays=t["chunk_rays"])
            t1 = time.perf_counter()
            self.cols.append(col)
            self.frame_s.append(t1 - t0)
            if tick is not None:
                tick(t1 - start, len(self.cols))
            if t1 - start >= seconds or len(self.cols) == len(self.poses):
                break
        return {"frames": len(self.cols), "rays": len(self.cols) * self.rays,
                "window_s": t1 - start, "frame_s": self.frame_s,
                "section": "eval"}

    def release(self):
        del self.model

    # ------------------------------------------------------------- check
    def sample(self):
        rng = np.random.default_rng([int(self.h.seed) % (2 ** 63), 12])
        n = min(int(self.tr["check_frames"]), len(self.cols))
        return sorted(rng.choice(len(self.cols), size=n, replace=False))

    def reference_scene(self):
        """The reference's grid, attribute table and weights, worked out
        once from inputs regenerated from the seed."""
        if getattr(self, "_ref_scene", None) is None:
            sc, attrs, sem, params = self.inputs()
            if sem is not None:
                attrs["sem_embedding"] = sem[2]
            del sc, sem
            grid = ref_pn.Grid(attrs["xyz"], self.ref)
            table = ref_pn.attribute_table(attrs, bool(self.ref["semantic"]),
                                           self.ref["gather_dtype"])
            self._ref_scene = grid, table, params
        return self._ref_scene

    def camera(self, i):
        it, dev = self.item(self.poses[i]), self.h.device
        return (torch.tensor(it["campos"], device=dev),
                torch.tensor(it["camrotc2w"], device=dev),
                torch.tensor(it["raydir"], device=dev))

    def reference_frames(self, idx, precision):
        """The reference's colours of frames `idx` at `precision`."""
        grid, table, params = self.reference_scene()
        mm = ref_pn.make_mm(precision)
        return [ref_pn.render_frame(
            grid, params, self.ref, table, *self.camera(i), mm,
            block=int(self.tr["ref_block_rays"])).cpu().numpy() for i in idx]

    def census(self, frames: int):
        """The query's work in the first `frames` frames, from the
        reference's sample selection over the same cameras: the shading
        points that hold a sample (`query_points`) and, a frame, the
        distinct voxels whose neighbour cache they read (`query_rows`)."""
        grid, _, _ = self.reference_scene()
        block, SR = int(self.tr["ref_block_rays"]), int(self.ref["SR"])
        points = rows = 0
        with torch.no_grad():
            for i in range(frames):
                campos, _, raydir = self.camera(i)
                vids = []
                for s in range(0, raydir.shape[0], block):
                    d = raydir[s:s + block]
                    ts = ref_pn.sample_depths(self.ref, d.shape[0], d.device)
                    loc, smask = ref_pn.shading_points(grid, campos, d, ts, SR)
                    vids.append(grid.lin(grid.coords(loc[smask])))
                v = torch.cat(vids)
                points += int(v.numel())
                rows += int(torch.unique(v).numel())
        return {"query_points": points, "query_rows": rows}

    def numbers(self, got, want):
        gap = np.abs(np.asarray(got, np.float64)
                     - np.asarray(want, np.float64)).max(-1)
        return {"frame_gap_max": float(gap.max()),
                "frame_gap_p999": float(np.quantile(gap, 0.999)),
                "frame_gap_p99": float(np.quantile(gap, 0.99)),
                "frame_gap_mean": float(gap.mean())}

    def check(self, control=None):
        """(numbers, answers compared): the sampled frames of the program
        (or, with `control`, of the reference at that lower precision in
        the program's place) against the reference at the stated
        precision; each number the worst over the frames."""
        idx = self.sample()
        want = self.reference_frames(idx, self.ref["products"])
        got = (self.reference_frames(idx, control) if control
               else [self.cols[i] for i in idx])
        per = [self.numbers(g, w) for g, w in zip(got, want)]
        return {k: max(p[k] for p in per) for k in per[0]}, len(want)
