"""The shading MLPs that run outside the fused kernels, as one function:
every MLP of the configuration's `unfused` list over its rows (neighbour
rows or shading points) at the configuration's product precision.
Bytes: the function's inputs read once (a neighbour row's embedding,
distance features, semantic embedding and weight, float32) and its
outputs written once (alpha and colour a shading point); the activations
between the MLPs are the implementation's."""
from nerfbench import yardstick as y


def count(cfg, rec):
    sec = cfg[rec["section"]]
    flops = 0.0
    for name in sec["unfused"]:
        mlp = cfg["mlps"][name]
        rows = (y.neighbour_rows(rec["rays"], cfg) if mlp["per"] == "neighbour"
                else y.shading_points(rec["rays"], cfg))
        flops += 2.0 * rows * y.mlp_macs(mlp["layers"])
    w = cfg["widths"]
    per_row = int(w["point_features"]) + 6 + int(w.get("semantic", 0)) + 1
    nbytes = (y.neighbour_rows(rec["rays"], cfg) * per_row * 4
              + y.shading_points(rec["rays"], cfg) * 4 * 4)
    return nbytes, [(flops, sec["precision"]["peak"])]
