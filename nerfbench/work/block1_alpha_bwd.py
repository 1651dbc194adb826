"""K3's function: the gradient of K2's function over every neighbour row
of the window's steps, given the rows and the cotangents of the K-sums.
Operations: the data and the weight gradients of block1's products (twice
the forward's) at the configuration's product precision, the alpha head's
and the K-sum's (4 C FLOP a row) on the CUDA cores. Whatever an
implementation recomputes is its own. Bytes: the rows read, their
gradients written, the cotangents read."""
from nerfbench import yardstick as y


def count(cfg, rec):
    sec = cfg[rec["section"]]
    M = y.shading_points(rec["rays"], cfg)
    rows = y.neighbour_rows(rec["rays"], cfg)
    C = int(cfg["widths"]["shading_features"])
    F = int(cfg["widths"]["point_features"])
    flops = [(4.0 * rows * y.mlp_macs(cfg["mlps"]["block1"]["layers"]),
              sec["precision"]["peak"]), (8.0 * rows * C, "fp32")]
    return 2 * rows * (F + 6 + 1) * 4 + M * (C + 1) * 4, flops
