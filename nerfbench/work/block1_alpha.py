"""K2's function: block1 over every neighbour row, the alpha head a row
and the K-sum of the features and alphas. Operations: block1's products
at the configuration's product precision; the alpha dot and the K-sum
(2 C FLOP each a row) on the CUDA cores. Bytes: the rows' embedding,
distance features and weight read (float32), C + 1 sums a shading point
written."""
from nerfbench import yardstick as y


def count(cfg, rec):
    sec = cfg[rec["section"]]
    M = y.shading_points(rec["rays"], cfg)
    rows = y.neighbour_rows(rec["rays"], cfg)
    C = int(cfg["widths"]["shading_features"])
    F = int(cfg["widths"]["point_features"])
    flops = [(2.0 * rows * y.mlp_macs(cfg["mlps"]["block1"]["layers"]),
              sec["precision"]["peak"]), (4.0 * rows * C, "fp32")]
    return rows * (F + 6 + 1) * 4 + M * (C + 1) * 4, flops
