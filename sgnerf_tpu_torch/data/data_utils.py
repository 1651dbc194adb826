"""Ray-direction helpers on numpy arrays (the reference's data/data_utils.py
import surface; counterpart of `sgnerf_tpu/data/data_utils.py`): thin
wrappers over ops/camera, and `flip_z`."""
import numpy as np
import torch

from ..ops.camera import get_blender_raydir as _bld
from ..ops.camera import get_dtu_raydir as _dtu


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def get_dtu_raydir(pixelcoords, intrinsic, rot, dir_norm=True):
    return _dtu(_t(pixelcoords), _t(intrinsic), _t(rot), dir_norm).numpy()


def get_blender_raydir(pixelcoords, height, width, focal, rot,
                       dir_norm=True):
    return _bld(_t(pixelcoords), height, width, focal, _t(rot),
                dir_norm).numpy()


def flip_z(poses):
    """(...,4,4) poses with their camera z axis negated."""
    z_flip = np.eye(4, dtype=np.float32)
    z_flip[2, 2] = -1.0
    return np.matmul(poses, z_flip[None, ...])
