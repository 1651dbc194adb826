"""Traffic kind `train_steps`: `SceneModel.optimize` runs fine-tuning steps
back to back, each on `rays` random pixels of one of `views` seeded
training views with seeded target colours (`--random_sample random`); the
host reads the losses every `sync_every` steps, as `run/train_ft.py` prints
them, and once at the window's end. Growing and pruning stay off.

Set-up drives the model through its first `check_steps` steps, on the
window's own call and feed; those steps are the ones the check follows.
The check: the plain reference follows the same steps from inputs
regenerated from the seed, with the same render noise (the benchmark gives
the model its noise generator and the reference the same draws). Compared:
each step's loss, the first gradient of each leaf as the optimizer got it
(Adam's first moment after one step over 1 - beta1) and each leaf's change
over the steps, each as a gap of norms against the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is below a thousandth of the median leaf's (nought to
rounding) are left out of the change.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .. import program, scene
from ..reference import pointnerf as ref_pn
from ..reference import train as ref_train

B1 = 0.9


class Driver:
    train = True

    def __init__(self, h):
        self.h = h
        self.cfg, self.tr = h.cfg, h.traffic
        self.sec = h.cfg["train"]
        t = h.traffic
        self.ref = {**self.sec["ref"], "near": t["near"], "far": t["far"],
                    "bg_color": t["bg_color"]}

    def inputs(self):
        h, cfg = self.h, self.cfg
        sc = scene.room_scan(int(cfg["scene"]["layout"]),
                             int(cfg["scene"]["n_points"]), h.device)
        attrs = scene.point_attributes(sc, h.seed,
                                       int(cfg["widths"]["point_features"]))
        params = program.mlp_weights(h.seed, cfg["mlps"], h.device)
        return sc, attrs, params

    def noise_gen(self):
        return scene.seed_gen(self.h.seed, 5, self.h.device)

    def batches(self):
        """The feed: an endless stream of batches drawn on the device from
        the seed, as a prefetching loader hands them over: a view, `rays`
        distinct pixels of it and their target colours. Each batch is a
        dict of device tensors (campos (3,), rot (3,3), raydir (rays,3),
        gt (rays,3))."""
        t, dev = self.tr, self.h.device
        gen = scene.seed_gen(self.h.seed, 21, dev)
        dirs = torch.as_tensor(self.dirs, device=dev)
        pos = torch.as_tensor(np.stack([p for p, _ in self.views]), device=dev)
        rots = torch.as_tensor(np.stack([r for _, r in self.views]),
                               device=dev)
        n = int(t["rays"])
        while True:
            # the pixels, and from the permutation's next entry the view
            pick = torch.randperm(dirs.shape[0], generator=gen, device=dev)
            v = pick[n] % len(self.views)
            gt = torch.rand((n, 3), generator=gen, device=dev)
            yield {"campos": pos[v], "rot": rots[v],
                   "raydir": dirs[pick[:n]] @ rots[v].T, "gt": gt}

    def program_batch(self, b):
        """A feed batch as SceneModel.optimize takes it (batch_to_device's
        layout, B = 1)."""
        t = self.tr
        return {"campos": b["campos"][None], "raydir": b["raydir"][None],
                "camrotc2w": b["rot"][None], "near": float(t["near"]),
                "far": float(t["far"]), "bg_color": self.bg,
                "gt_image": b["gt"][None]}

    def leaves(self):
        from sgnerf_tpu_torch.models.train import param_leaves, trained_fields
        st = self.model.state
        names = ref_train.param_names(st.params)
        fields = trained_fields(self.model.tcfg)
        return (dict(zip(names, param_leaves(st.params)))
                | {f: getattr(st.cloud, f) for f in fields}), names, fields

    def setup(self):
        h, t = self.h, self.tr
        sc, attrs, params = self.inputs()
        self.model, self.scene_build_s = program.build_model(
            self.sec["flags"], True, h.device, attrs, params, None, h.workdir)
        del attrs, params
        if h.fault is not None:
            h.fault(self.model)
        self.boxes = sc.boxes
        del sc
        self.dirs = scene.pixel_dirs(t["width"], t["height"], t["focal"])
        self.views = scene.draw_poses(h.seed, 20, int(t["views"]),
                                      self.boxes, t["wall_margin"],
                                      t["pitch"])
        self.bg = torch.tensor(t["bg_color"], dtype=torch.float32,
                               device=h.device)
        self.feed = self.batches()
        self.model.generator = self.noise_gen()
        leaves, names, fields = self.leaves()
        n_act = int(self.model.cloud.n_active)
        first = {n: (v.detach()[:n_act] if n in fields else v.detach()).to(
            "cpu", copy=True) for n, v in leaves.items()}
        self.prog_losses = []
        for i in range(int(t["check_steps"])):
            losses = self.model.optimize(self.program_batch(next(self.feed)))
            self.prog_losses.append(float(losses["total"]))
            if i == 0:
                st = self.model.state
                m = dict(zip(names, st.opt_net["m"])) | dict(
                    zip(fields, st.opt_pts["m"]))
                self.prog_grad1 = {n: float(torch.linalg.norm(
                    m[n].double()) / (1 - B1)) for n in m}
        leaves, _, _ = self.leaves()
        self.prog_change = {n: float(torch.linalg.norm(
            (v.detach()[:n_act].cpu() if n in fields else v.detach().cpu())
            .double() - first[n].double())) for n, v in leaves.items()}
        del first

    def window(self, seconds: float, tick=None):
        t = self.tr
        every = int(t["sync_every"])
        steps = 0
        start = time.perf_counter()
        while True:
            losses = self.model.optimize(self.program_batch(next(self.feed)))
            steps += 1
            if steps % every == 0:
                float(losses["total"])
            elapsed = time.perf_counter() - start
            if tick is not None:
                tick(elapsed, steps)
            if elapsed >= seconds:
                break
        float(losses["total"])
        program.sync(self.h.device)
        return {"steps": steps, "rays": steps * int(t["rays"]),
                "window_s": time.perf_counter() - start, "section": "train"}

    def release(self):
        del self.model

    # ------------------------------------------------------------- check
    def reference(self, precision):
        """(losses, first gradient norms, change norms) of the reference
        over the check steps at `precision`."""
        h, t = self.h, self.tr
        sc, attrs, params = self.inputs()
        del sc
        n = int(t["check_steps"])
        feed = self.batches()
        gen = self.noise_gen()
        dev = h.device
        batches, noise = [], []
        for _ in range(n):
            b = next(feed)
            batches.append(b)
            noise.append(torch.rand((1, b["raydir"].shape[0],
                                     int(self.ref["D"])), generator=gen,
                                    device=dev)[0])
        first = {k: v.detach().clone() for k, v in attrs.items()
                 if k in self.sec["tcfg"]["fields"]}
        first |= {f"{b}.{i}.{k}": l[k].detach().clone()
                  for b in params for i, l in enumerate(params[b])
                  for k in ("w", "b")}
        losses, grad1, after = ref_train.train_steps(
            attrs, params, self.ref, self.sec["tcfg"], batches, noise,
            ref_pn.make_mm(precision))
        change = {k: float(torch.linalg.norm((after[k] - first[k]).double()))
                  for k in after}
        return losses, grad1, change

    @staticmethod
    def gaps(got, want, skip=()):
        keys = [k for k in want if k not in skip]
        scale = statistics.median(want[k] for k in keys)
        return max(abs(got[k] - want[k]) / max(want[k], scale, 1e-30)
                   for k in keys)

    def numbers(self, got, want):
        (l_g, g_g, c_g), (l_w, g_w, c_w) = got, want
        med = statistics.median(g_w.values())
        quiet = [k for k, v in g_w.items() if v < 1e-3 * med]
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l_g, l_w)),
                "grad1_gap": self.gaps(g_g, g_w),
                "change_gap": self.gaps(c_g, c_w, quiet)}

    def check(self, control=None):
        """(numbers, steps compared): the program's check steps (or, with
        `control`, the reference's at that lower precision in the
        program's place) against the reference at the stated precision."""
        want = self.reference(self.ref["products"])
        got = (self.reference(control) if control else
               (self.prog_losses, self.prog_grad1, self.prog_change))
        return self.numbers(got, want), int(self.tr["check_steps"])
