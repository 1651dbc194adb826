"""Per-scene fine-tuning on the port.

    python -m sgnerf_tpu_torch.run.train_ft <the flags of run/train_ft.py>

Counterpart of run/train_ft.py (reference run/train_ft.py):
  1. parse the flags, create the dataset and the SceneModel (on
     cuda:<--gpu_ids>; `--gpu_ids -1` is the CPU with the kernels' plain
     versions);
  2. resume from a checkpoint, or bootstrap the cloud: the scene's init
     points (`--load_points 1`), voxel-downsampled, with initialised
     per-point attributes; the dataset's depth maps unprojected
     (`--load_points 2`); or the MVS bootstrap (`--load_points 0`,
     runtime/mvs_bootstrap.py: depths, cross-view filtering, FeatureNet
     embeddings); with `--bgmodel plane`, each train frame's plane
     background, which the batches index;
  3. train on random-ray batches from a background item prefetcher; print,
     prune, save and test on their schedules (`--steps_per_dispatch` G runs
     G steps between host events); every `--prob_freq` steps, after the
     prune, grow points into the scan's holes (runtime/growing.py; with
     the default opacity threshold 0.7, not `--prob_thresh`, as
     run/train_ft.py calls it); with `--predict_semantic 1`, BPNet refreshes
     the points' semantics before each step group (runtime/semantic.py,
     in the background after the first) and its 2D labels become the
     batch's pixel labels; a refresh in flight is applied before saves and
     tests;
  4. final save, reference `.pth` export and test.
`--profile_dir` writes a torch.profiler trace of steps [profile_start,
profile_start + profile_steps), the `sgnerf.step.*` spans in it, and
prints the spans' summary of those steps (utils/spans.py).
"""
from __future__ import annotations

import copy
import os
import queue
import threading
import time

import numpy as np
import torch

from ..data import create_dataset
from ..models.background import create_all_bg, plane_bg_ray
from ..models.point_cloud import make_point_cloud
from ..options.options import TrainOptions, configs_from_opt
from ..runtime.growing import probe_and_grow
from ..runtime.scene_model import SceneModel, batch_to_device
from ..runtime.semantic import SemanticDriver
from ..utils import spans
from ..utils.metrics import psnr
from ..utils.visualizer import Visualizer


class ItemPrefetcher:
    """Background threads load items (jpeg decode, pixel sampling) while
    the device trains; the reference relies on DataLoader workers."""

    def __init__(self, dataset, depth: int = 4, n_threads: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self.dataset = dataset
        self.stop = threading.Event()

        def worker(seed):
            r = np.random.default_rng(seed)
            while not self.stop.is_set():
                item = self.dataset.get_item(
                    int(r.integers(0, len(self.dataset))), rng=r)
                while not self.stop.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self.threads = [threading.Thread(target=worker, args=(1000 + t,),
                                         daemon=True)
                        for t in range(max(1, n_threads))]
        for t in self.threads:
            t.start()

    def next(self):
        return self.q.get()

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=10)


def check_flags(opt):
    """Refuse, before any work, what this driver does not port yet and
    what configs_from_opt refuses."""
    configs_from_opt(opt, device="cpu")


def run_test(model, dataset, visualizer, total_steps, num_images=None,
             step_stride=1):
    """Render test frames, save the images, return the mean PSNR."""
    ids = list(range(len(dataset)))[::step_stride]
    if num_images:
        ids = ids[:num_images]
    psnrs = []
    subdir = f"test_{total_steps}"
    init_views = cloud_xyz = None
    if str(model.opt.bgmodel).endswith("plane") and hasattr(
            dataset, "get_init_item"):
        init_views = dataset.get_init_item(0)
        cloud_xyz = model.cloud.xyz[model.cloud.active].cpu().numpy()
    for i in ids:
        item = dataset.get_item(i, full_img=True)
        bg_image = (plane_bg_ray(item, init_views, cloud_xyz,
                                 device=model.device)
                    if init_views is not None else None)
        t0 = time.time()
        col = model.render_image(item, bg_image=bg_image)
        npx = item["pixel_idx"]
        W = int(npx[:, 0].max() - npx[:, 0].min() + 1)
        H = len(col) // W
        img = col[:H * W].reshape(H, W, 3)
        gt = item["gt_image"][:H * W].reshape(H, W, 3)
        p = psnr(img, gt)
        psnrs.append(p)
        print(f"test img {i} psnr: {p:.3f}  time used: "
              f"{time.time() - t0:.3f} s", flush=True)
        visualizer.display_current_results(
            {"coarse_raycolor": img, "gt_image": gt}, i, subdir=subdir)
    mean_psnr = float(np.mean(psnrs)) if psnrs else 0.0
    print(f"test mean psnr over {len(psnrs)} imgs: {mean_psnr:.3f}")
    return mean_psnr


def _test_dataset(opt):
    topt = copy.copy(opt)
    topt.split = "test"
    topt.random_sample = "no_crop"
    return create_dataset(topt)


def main(args=None):
    opt = TrainOptions().parse(args)
    opt.split = "train"
    check_flags(opt)
    TrainOptions().save(opt)
    visualizer = Visualizer(opt)
    dataset = create_dataset(opt)

    model = SceneModel(opt)
    resume = model.resolve_resume()
    if resume is not None:
        model.load_checkpoint(resume)
    elif opt.load_points < 1:
        # MVS depths -> cross-view filter -> embeddings (reference
        # gen_points_filter_embeddings, run/train_ft.py:101-170)
        from ..runtime.mvs_bootstrap import gen_points_filter_embeddings
        xyz, emb, color, dirs, conf = gen_points_filter_embeddings(
            dataset, opt, model.device)
        print(f"MVS bootstrap produced {len(xyz)} points")
        model._finish_setup(None, make_point_cloud(
            xyz, emb, conf=conf, dir=dirs, color=color,
            capacity=model._capacity_for(len(xyz)), device=model.device))
    elif opt.load_points == 2:
        # the dataset's depth maps unprojected (run/train_ft.py:668)
        xyz = dataset.load_init_depth_points(vox_res=100)
        model.setup_from_points(xyz, None, None, dataset=dataset)
    else:
        xyz, feats, labels = dataset.load_init_points()
        model.setup_from_points(xyz, feats, labels, dataset=dataset)

    semantic = (SemanticDriver(opt, model.device)
                if int(opt.predict_semantic) else None)

    total_steps = int(model.step)
    # --maximum_step 0 trains no step (the dtu_test_inf scripts render at
    # once); unset, 100000
    maximum_step = (100000 if opt.maximum_step is None
                    else int(opt.maximum_step))
    rng = np.random.default_rng(1)
    grow_rng = np.random.default_rng(2)     # the probe frames' seeds
    print(f"training from step {total_steps} to {maximum_step}")
    t_start = time.time()
    prefetcher = (ItemPrefetcher(dataset, n_threads=opt.n_threads)
                  if opt.n_threads > 0 else None)
    G_max = 1 if opt.profile_dir else max(1, int(opt.steps_per_dispatch))
    profiler = None
    test_ds = None

    def next_event(step):
        nxt = maximum_step
        for freq in (opt.print_freq, opt.save_iter_freq, opt.save_point_freq,
                     opt.prune_iter, opt.prob_freq, opt.test_freq):
            if freq and freq > 0:
                nxt = min(nxt, (step // freq + 1) * freq)
        return nxt

    # --bgmodel *plane: a full-frame plane background per train frame
    # (reference run/train_ft.py:559-586); each batch indexes its pixels
    bg_all = None
    if str(opt.bgmodel).endswith("plane"):
        bg_all = create_all_bg(
            dataset, model.cloud.xyz[model.cloud.active].cpu().numpy(),
            device=model.device)
        if bg_all is not None:
            print(f"[bgmodel] plane backgrounds for {len(bg_all)} frames")

    def get_item():
        if prefetcher is not None:
            item = prefetcher.next()
        else:
            item = dataset.get_item(int(rng.integers(0, len(dataset))),
                                    rng=rng)
        if bg_all is not None:
            px = np.asarray(item["pixel_idx"]).astype(np.int64)
            item["bg_ray"] = bg_all[int(item["id"])][px[:, 1], px[:, 0]]
        return item

    try:
        while total_steps < maximum_step:
            G = min(G_max, next_event(total_steps) - total_steps)
            if opt.profile_dir and total_steps == opt.profile_start:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if model.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                spans.reset()
                profiler.start()
            items = [get_item() for _ in range(G)]
            model.ensure_pspec(items[0])     # --wcoord_query 0's frustum
            if semantic is not None:
                semantic.maybe_refresh(model, items[0], steps=G)
                for it in items:
                    pl = semantic.pixel_labels_for(it)
                    if pl is not None:
                        it["pixel_label"] = pl
            batches = [batch_to_device(it, model.device) for it in items]
            for losses in model.optimize_multi(batches):
                visualizer.accumulate_losses(losses)
            total_steps += G
            if profiler is not None and \
                    total_steps >= opt.profile_start + opt.profile_steps:
                profiler.stop()
                os.makedirs(opt.profile_dir, exist_ok=True)
                path = os.path.join(opt.profile_dir,
                                    f"train_ft_{total_steps}.json")
                profiler.export_chrome_trace(path)
                profiler = None
                print(f"profiler trace written to {path}")
                print(spans.table())

            if total_steps % opt.print_freq == 0:
                visualizer.print_losses(total_steps)
                visualizer.reset()
            if opt.prune_iter > 0 and total_steps % opt.prune_iter == 0 \
                    and total_steps <= opt.prune_max_iter:
                model.prune_points(opt.prune_thresh)
            if opt.prob_freq > 0 and total_steps % opt.prob_freq == 0:
                probe_and_grow(model, dataset, opt,
                               int(grow_rng.integers(0, 2 ** 32)))
            if semantic is not None and (
                    total_steps % opt.save_iter_freq == 0
                    or (opt.test_freq > 0
                        and total_steps % opt.test_freq == 0)):
                semantic.flush(model)
            if total_steps % opt.save_iter_freq == 0:
                model.save_checkpoint(total_steps)
            if opt.save_point_freq > 0 and \
                    total_steps % opt.save_point_freq == 0:
                c = model.cloud
                act = c.active.cpu().numpy()
                visualizer.save_neural_points(
                    total_steps, c.xyz.cpu().numpy()[act],
                    colors=c.color.detach().cpu().numpy()[act])
            if opt.test_freq > 0 and total_steps % opt.test_freq == 0:
                test_ds = test_ds or _test_dataset(opt)
                mean_psnr = run_test(model, test_ds, visualizer, total_steps,
                                     num_images=opt.test_num,
                                     step_stride=opt.test_num_step)
                if mean_psnr > model.best_psnr:
                    model.best_psnr = mean_psnr
                    model.best_iter = total_steps
                    model.save_checkpoint(total_steps, best=True)
    finally:
        if profiler is not None:
            profiler.stop()
        if prefetcher is not None:
            prefetcher.close()
    if semantic is not None:
        semantic.flush(model)

    print(f"training done in {time.time() - t_start:.1f}s; saving final")
    model.save_checkpoint(total_steps)
    model.export_reference(total_steps)
    run_test(model, test_ds or _test_dataset(opt), visualizer, total_steps,
             num_images=opt.test_num, step_stride=1)


if __name__ == "__main__":
    main()
