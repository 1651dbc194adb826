"""Datasets of the port: scannet_ft, nerf_synth_ft, dtu and dtu_ft."""
from __future__ import annotations


def create_dataset(opt):
    if opt.dataset_name == "scannet_ft":
        from .scannet_ft_dataset import ScannetFtDataset
        return ScannetFtDataset(opt)
    if opt.dataset_name == "nerf_synth_ft":
        from .nerf_synth_ft_dataset import NerfSynthFtDataset
        return NerfSynthFtDataset(opt)
    if opt.dataset_name == "dtu":
        from .dtu_dataset import DtuDataset
        return DtuDataset(opt)
    if opt.dataset_name == "dtu_ft":
        from .dtu_ft_dataset import DtuFtDataset
        return DtuFtDataset(opt)
    raise ValueError(f"unknown dataset {opt.dataset_name!r}: the port reads "
                     "scannet_ft, nerf_synth_ft, dtu and dtu_ft")
