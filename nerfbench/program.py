"""The system under test: the PyTorch port, set up in memory from the
benchmark's inputs. Nothing is written to disk but the program's own
experiment directory, which SceneModel makes (empty) under the run's
build directory.

There is no public entry that takes a cloud and parameters in memory: the
scene goes in through `SceneModel._finish_setup`, the path that
checkpoint loading and the point bootstrap share.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from .scene import seed_gen

GAIN_LEAKY = (2.0 / (1 + 0.01 ** 2)) ** 0.5


def mlp_weights(seed: int, mlps: Dict, device) -> Dict:
    """Aggregator weights from the seed, drawn on `device` by the
    reference's init law (W ~ U(+-gain sqrt(6/(in+out))), b ~
    U(+-1/sqrt(in)), LeakyReLU gain), in the (in, out) layout of x @ w:
    {block: [{"w", "b"}, ...]}. One draw a block."""
    gen = seed_gen(seed, 4, device)
    out = {}
    for name in sorted(mlps):
        layers = mlps[name]["layers"]
        n = sum(i * o + o for i, o in layers)
        u = torch.rand((n,), generator=gen, device=device) * 2 - 1
        blk, at = [], 0
        for i, o in layers:
            lim = GAIN_LEAKY * (6.0 / (i + o)) ** 0.5
            w = u[at:at + i * o].reshape(i, o) * lim
            at += i * o
            b = u[at:at + o] / i ** 0.5
            at += o
            blk.append({"w": w.contiguous(), "b": b.contiguous()})
        out[name] = blk
    return out


def options(flags, train: bool, device, workdir: str):
    from sgnerf_tpu_torch.options import TestOptions, TrainOptions
    gpu = "-1" if torch.device(device).type == "cpu" else "0"
    extra = ["--gpu_ids", gpu, "--checkpoints_dir", workdir,
             "--name", "nerfbench"]
    return (TrainOptions() if train else TestOptions()).parse(
        list(flags) + extra)


def point_cloud(attrs: Dict, capacity: int, sem: Optional[tuple]):
    """The program's cloud on the device, padded to `capacity` as its
    constructor pads (padding rows at 1e9, zeros elsewhere)."""
    from sgnerf_tpu_torch.models.point_cloud import NeuralPointCloud
    xyz = attrs["xyz"]
    n, dev = xyz.shape[0], xyz.device

    def pad(t, fill=0.0, dtype=torch.float32):
        out = torch.full((capacity,) + tuple(t.shape[1:]), fill, dtype=dtype,
                         device=dev)
        out[:n] = t
        return out

    n_cls, s_dim = (sem[0].shape[1], sem[2].shape[1]) if sem else (20, 96)
    active = torch.zeros(capacity, dtype=torch.bool, device=dev)
    active[:n] = True
    return NeuralPointCloud(
        xyz=pad(xyz, 1e9), embedding=pad(attrs["embedding"]),
        conf=pad(attrs["conf"]), dir=pad(attrs["dir"]),
        color=pad(attrs["color"]),
        feats=torch.zeros((capacity, 3), device=dev),
        label=torch.zeros(capacity, dtype=torch.int32, device=dev),
        label_prob=torch.zeros((capacity, n_cls), device=dev),
        sem_embedding=torch.zeros((capacity, s_dim), device=dev),
        Rw2c=torch.eye(3, device=dev),
        rot_idx=torch.zeros(capacity, dtype=torch.int32, device=dev),
        active=active,
        n_active=torch.tensor(n, dtype=torch.int32, device=dev))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_model(flags, train: bool, device, attrs: Dict, params: Dict,
                sem: Optional[tuple], workdir: str):
    """SceneModel over the benchmark's cloud and weights. Returns (model,
    seconds from the cloud on the device to a renderable grid and, for
    eval, the attribute table)."""
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    os.makedirs(workdir, exist_ok=True)
    opt = options(flags, train, device, workdir)
    model = SceneModel(opt, device=device)
    cloud = point_cloud(attrs, model._capacity_for(attrs["xyz"].shape[0]),
                        sem)
    host_params = {k: [{n: t.detach().cpu().numpy() for n, t in l.items()}
                       for l in v] for k, v in params.items()}
    sync(device)
    t0 = time.perf_counter()
    model._finish_setup(host_params, cloud)
    if sem is not None:
        model.set_semantics(*sem)
    if not train:
        model.table
    sync(device)
    return model, time.perf_counter() - t0
