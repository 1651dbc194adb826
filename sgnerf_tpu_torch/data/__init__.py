"""Datasets of the port (eval slice: scannet_ft)."""
from __future__ import annotations


def create_dataset(opt):
    if opt.dataset_name != "scannet_ft":
        raise NotImplementedError(
            f"dataset {opt.dataset_name!r} is not ported yet (ROADMAP.md, "
            "queue 1 items 12-13); the port reads scannet_ft")
    from .scannet_ft_dataset import ScannetFtDataset
    return ScannetFtDataset(opt)
