"""How the train step's gradient check meets LeakyReLU's branches.

The kernel path's backward (K3) reads the LeakyReLU branches of the
forward that ran (K2's activations, which K3a recomputes bit for bit);
the un-fused path reads those of its own f32 forward. The two forwards
differ within rounding, so a few of a step's ~100M block1 activations lie
on different sides of zero. This runs chip_smoke.py's phase-6 comparison
(`step_diff`, one step from the same state and noise, kernel path against
un-fused path) for many noise seeds, on the room scan's initial state and
after the phase's 9 steps, and prints for each the loss difference, the
worst gradient difference with the un-fused block1 on the kernel
forward's branches and on its own, and the activations on the other
branch per layer. Run from the repository root, on the card:

    python -m sgnerf_tpu_torch.dev.probe_step_branches
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch

import chip_smoke as cs

from ..options import TestOptions, TrainOptions
from ..runtime.scene_model import SceneModel

SEEDS_INITIAL, SEEDS_TRAINED = 6, 24


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(os.path.join(cs.REPO, "build", "smoke"), ignore_errors=True)
    model, _ = cs.build_scene(TestOptions().parse(cs.TEST_DEFAULT_FLAGS),
                              cs.N_POINTS)
    del model
    item = cs.frame_item()
    opt = TrainOptions().parse(cs.TRAIN_FLAGS + [
        "--name", "smoke", "--checkpoints_dir",
        os.path.join(cs.REPO, "build")])
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    cfg = model.cfg
    batch = cs.train_batch(item, model.device)
    plain = dataclasses.replace(cfg, agg=dataclasses.replace(
        cfg.agg, fused_mlp="none"))

    def show(state, seeds):
        for seed in range(seeds):
            loss, on_branches, own, flips = cs.step_diff(
                model, cfg, plain, batch, seed=seed, on_branches=True)
            print(json.dumps({"state": state, "seed": seed, "loss": loss,
                              "grad_on_forward_branches": on_branches,
                              "grad_on_own_branches": own,
                              "flips_per_layer": flips}), flush=True)
    show("initial", SEEDS_INITIAL)
    for _ in range(cs.TRAIN_STEPS + 1):
        model.optimize(batch)
    torch.cuda.synchronize()
    show("after 9 steps", SEEDS_TRAINED)


if __name__ == "__main__":
    main()
