"""k1_roofline.eval: K1's share of its roofline (bytes-bound: its cache
rows) over the traced window."""
from nerfbench import yardstick as y


def read(rec):
    return y.roofline(rec, "k1") if rec.get("section") == "eval" else None
