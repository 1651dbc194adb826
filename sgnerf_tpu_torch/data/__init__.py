"""Datasets of the port: scannet_ft and nerf_synth_ft."""
from __future__ import annotations


def create_dataset(opt):
    if opt.dataset_name == "scannet_ft":
        from .scannet_ft_dataset import ScannetFtDataset
        return ScannetFtDataset(opt)
    if opt.dataset_name == "nerf_synth_ft":
        from .nerf_synth_ft_dataset import NerfSynthFtDataset
        return NerfSynthFtDataset(opt)
    raise NotImplementedError(
        f"dataset {opt.dataset_name!r} is not ported yet (ROADMAP.md, "
        "queue 1 item 13); the port reads scannet_ft and nerf_synth_ft")
