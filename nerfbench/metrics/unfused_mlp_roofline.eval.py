"""unfused_mlp_roofline.eval: the un-fused shading MLPs' FLOPs at the
configuration's product peak over the device time of the GEMM kernels
that layers/unfused_mlp.json assigns them."""
from nerfbench import yardstick as y


def read(rec):
    return (y.roofline(rec, "unfused_mlp") if rec.get("section") == "eval"
            else None)
