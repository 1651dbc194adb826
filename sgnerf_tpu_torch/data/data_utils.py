"""Ray-direction helper on numpy arrays (the reference's data/data_utils.py
import surface; counterpart of `sgnerf_tpu/data/data_utils.py`): a thin
wrapper over ops/camera. The blender spin path's `get_blender_raydir` and
`flip_z` are left out until a command line renders that path."""
import numpy as np
import torch

from ..ops.camera import get_dtu_raydir as _dtu


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def get_dtu_raydir(pixelcoords, intrinsic, rot, dir_norm=True):
    return _dtu(_t(pixelcoords), _t(intrinsic), _t(rot), dir_norm).numpy()
