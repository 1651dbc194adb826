"""SemanticDriver: runs BPNet over the point cloud during training and
feeds its predictions to the renderer.

Counterpart of `sgnerf_tpu/runtime/semantic.py` (reference
neural_points_volumetric_model.py:464-540): with `--predict_semantic 1`
BPNet runs over the whole neural point cloud and view_num train images,
writes (labels, probs, 96-d embeddings) onto the points and gives the
per-pixel labels of its 2D prediction to the semantic-guided query.

The first refresh runs synchronously, so the guided query has semantics
from step 0. Later ones, due every `--bpnet_refresh_every` steps, run on a
background thread: the point snapshot (a device->host read) is taken on
the calling thread, then image IO, links, voxelization, the forward and
the devoxelize overlap the following train steps, and the result is
applied at the first call after the worker finishes (one refresh in
flight at a time; a tick due while one runs is skipped).

On a CUDA device every BPNet call runs on SemanticDriver's own stream: the
worker's kernels overlap the train step's instead of queueing behind them
on the default stream. The main stream waits on the refresh's event before
the outputs are written into the cloud, and the outputs are recorded on the
main stream so the allocator keeps them until that write is done. An
exception in the worker is raised in the caller at the next harvest (the
JAX SemanticDriver's thread prints its traceback and the cloud keeps its stale
semantics).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..models.bpnet import BPNet, BPNetConfig


class SemanticDriver:
    def __init__(self, opt, device, params=None, seed: int = 7):
        self.cfg = BPNetConfig(
            classes=opt.classes, view_num=3, img_wh=tuple(opt.img_wh),
            layers_2d=opt.layers_2d,
            compute_dtype=getattr(opt, "bpnet_dtype", "float32"),
            aug=int(getattr(opt, "bpnet_aug", 0)))
        self.device = torch.device(device)
        self.bpnet = BPNet(self.cfg, params=params, seed=seed,
                           device=self.device)
        self.refresh_every = max(1, int(getattr(opt, "bpnet_refresh_every",
                                                1)))
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._step = 0
        self._last = None                  # the last applied outputs
        self._pixel_label_maps: Optional[np.ndarray] = None
        self._worker: Optional[threading.Thread] = None
        self._result = None                # (outputs, event) or exception
        self._lock = threading.Lock()
        self.n_applied = 0       # refreshes applied to the cloud
        self.n_background = 0    # of those launched, on the background thread

    # ---------------------------------------------------------------- internal

    def _snapshot(self, model, item):
        """The live rows' xyz and colours to the host, on the calling
        thread (the train step updates the cloud in place)."""
        cloud = model.cloud
        act = cloud.active.cpu().numpy()
        locs = cloud.xyz.detach().cpu().numpy()[act]
        feats = cloud.feats.detach().cpu().numpy()[act]
        intr4 = np.eye(4)
        intr4[:3, :3] = np.asarray(item["intrinsic"])[:3, :3]
        return locs, feats, item["train_id_paths"], item["image_path"], intr4

    def _follow_caller(self) -> None:
        """The refresh stream starts after what the caller queued so far
        (the weights' upload, the step that ran before the snapshot)."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _run(self, snap):
        """One BPNet refresh on the refresh stream. Returns (outputs, the
        event recorded after them, or None on the CPU)."""
        if self.stream is None:
            return self.bpnet.train_bpnet(*snap, device_out=True), None
        with torch.cuda.stream(self.stream):
            out = self.bpnet.train_bpnet(*snap, device_out=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _apply(self, model, out, event) -> None:
        labels, probs, labels2d, point_feat, _ = out
        if event is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            for t in (labels, probs, point_feat):
                t.record_stream(main)
        model.set_semantics(probs, labels, point_feat)
        self._last = out
        self._pixel_label_maps = labels2d          # (V,h,w)
        self.n_applied += 1

    def _launch(self, snap) -> None:
        self._follow_caller()
        self.n_background += 1

        def work():
            try:
                res = self._run(snap)
            except BaseException as e:     # handed to the caller, re-raised
                res = e
            with self._lock:
                self._result = res

        self._worker = threading.Thread(target=work, daemon=True,
                                        name="bpnet-refresh")
        self._worker.start()

    def _harvest(self, model, wait: bool = False) -> None:
        if self._worker is None:
            return
        if wait:
            self._worker.join()
        elif self._worker.is_alive():
            return
        self._worker = None
        with self._lock:
            res, self._result = self._result, None
        if isinstance(res, BaseException):
            raise RuntimeError("the background BPNet refresh failed") from res
        self._apply(model, *res)

    # ------------------------------------------------------------------ public

    @property
    def in_flight(self) -> bool:
        """A background refresh is running."""
        return self._worker is not None and self._worker.is_alive()

    def maybe_refresh(self, model, item, steps: int = 1) -> None:
        """Apply a finished background refresh; start the next when one is
        due (the first-ever refresh synchronously). `steps`: the optimizer
        steps the caller runs before its next call."""
        self._harvest(model)
        due = (self._last is None
               or self._step % self.refresh_every == 0
               or (self._step // self.refresh_every)
               != ((self._step + steps - 1) // self.refresh_every))
        self._step += steps
        if not due:
            return
        if self._last is None:
            self._harvest(model, wait=True)        # an in-flight first run
            if self._last is not None:
                return
            snap = self._snapshot(model, item)
            self._follow_caller()
            self._apply(model, *self._run(snap))
        elif self._worker is None:
            self._launch(self._snapshot(model, item))

    def flush(self, model) -> None:
        """Block until an in-flight refresh is applied (before saves and
        tests, so exported semantics are never mid-flight)."""
        self._harvest(model, wait=True)

    def pixel_labels_for(self, item) -> Optional[np.ndarray]:
        """Per-pixel labels of BPNet's 2D prediction for the batch's pixels
        (view 0, the current frame when it is in the split)."""
        if self._pixel_label_maps is None:
            return None
        m = self._pixel_label_maps[0]              # (h,w)
        pix = np.asarray(item["pixel_idx"]).astype(np.int64)
        h, w = m.shape
        x = np.clip(pix[:, 0], 0, w - 1)
        y = np.clip(pix[:, 1], 0, h - 1)
        return m[y, x].astype(np.int32)
