"""Per-scene DTU dataset (`--dataset_name dtu_ft`; counterpart of
`sgnerf_tpu/data/dtu_ft_dataset.py`).

The dtu_test_inf scripts select `dataset_name='dtu_ft'`, a module the
reference repo never shipped. It is the MVSNet-layout loader of
dtu_dataset.py with the plane background (`--bgmodel *plane`) attached:
the vendored Point-NeRF dtu_ft dataset gives every item the scan's ground
plane (pointnerf/data/dtu_ft_dataset.py:732-735,894-899), its index read
from `{data_root}/dtu_test_ground.txt` lines of "scanN idx" (0 without
the file).
"""
from __future__ import annotations

import os

import numpy as np

from .dtu_dataset import DtuDataset

# vendored pointnerf/data/dtu_ft_dataset.py:894-899 — per-scan DTU ground
# plane (a point on the plane, its normal, and the table's albedo used by
# the plane-color fit filter in set_bg)
_PLANE_PNT = [[-0.49666997, 0.52160616, 3.6239593],
              [0.20770223, -0.74818161, 3.98697683],
              [-0.04889537, -0.84123057, 4.03164617]]
_PLANE_NORMAL = [[-0.11364093, 0.38778102, 0.91471942],
                 [-0.11165793, 0.3806543, 0.91795142],
                 [-0.11154823, 0.3783277, 0.91892608]]
_PLANE_COLOR = [[1.0, 1.0, 1.0],
                [150.72447808 / 255, 99.68367002 / 255, 63.40976961 / 255],
                [80.28243032 / 255, 54.3915082 / 255, 35.07029825 / 255]]


class DtuFtDataset(DtuDataset):

    def __init__(self, opt):
        super().__init__(opt)
        self.plane_ind = 0
        lst = os.path.join(str(opt.data_root), "dtu_test_ground.txt")
        if os.path.exists(lst):
            for line in open(lst):
                info = line.strip().split()
                if len(info) >= 2 and info[0] == str(self.scan):
                    self.plane_ind = int(info[1])
                    break

    def _attach_plane(self, item):
        if str(getattr(self.opt, "bgmodel", "no")).endswith("plane"):
            i = self.plane_ind
            item["plane_pnt"] = np.asarray(_PLANE_PNT[i], np.float32)
            item["plane_normal"] = np.asarray(_PLANE_NORMAL[i], np.float32)
            item["plane_color"] = np.asarray(_PLANE_COLOR[i], np.float32)
        return item

    def get_item(self, idx, full_img=False, rng=None):
        return self._attach_plane(super().get_item(idx, full_img, rng))
