"""Faults planted under a run, to show that the check catches them: each
wraps the program's entry that the window drives, after set-up built it.

eval_frames: `stale` (a frame returns the previous frame's colours: the
state left unchanged), `half` (half of the rays left out, background in
their place), `altered` (one pixel's colour moved by 1e-3 where it is
produced). train_steps: `unchanged` (a step computes its losses and
updates nothing), `half` (the step on the first half of its rays, the mean
over them), `altered` (the step's reported loss moved by 1%).
There is no exchange between cards to leave out: every cell runs on one.
"""
from __future__ import annotations

import numpy as np


def eval_stale(model):
    render, last = model.render_image, []

    def wrapped(item, **kw):
        out = render(item, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    model.render_image = wrapped


def eval_half(model):
    render = model.render_image

    def wrapped(item, **kw):
        n = len(item["raydir"])
        out = render(dict(item, raydir=item["raydir"][:n // 2]), **kw)
        rest = np.broadcast_to(np.asarray(item["bg_color"], np.float32),
                               (n - n // 2, 3))
        return np.concatenate([out, rest])
    model.render_image = wrapped


def eval_altered(model):
    render = model.render_image

    def wrapped(item, **kw):
        out = render(item, **kw)
        out[len(out) // 3] += 1e-3
        return out
    model.render_image = wrapped


def train_unchanged(model):
    from sgnerf_tpu_torch.models.train import loss_and_grads

    def wrapped(batch):
        losses, _, _ = loss_and_grads(model.state, model.grid, model.cfg,
                                      model.tcfg, batch,
                                      generator=model._generator())
        return losses
    model.optimize = wrapped


def train_half(model):
    step = model.optimize

    def wrapped(batch):
        h = batch["raydir"].shape[1] // 2
        return step(dict(batch, raydir=batch["raydir"][:, :h],
                         gt_image=batch["gt_image"][:, :h]))
    model.optimize = wrapped


def train_altered(model):
    step = model.optimize

    def wrapped(batch):
        losses = step(batch)
        return dict(losses, total=losses["total"] * 1.01)
    model.optimize = wrapped


FAULTS = {"eval_frames": {"stale": eval_stale, "half": eval_half,
                          "altered": eval_altered},
          "train_steps": {"unchanged": train_unchanged, "half": train_half,
                          "altered": train_altered}}
