"""k2_roofline.eval: K2's share of its roofline (operations-bound:
block1's products at the configuration's product peak) over the traced
window."""
from nerfbench import yardstick as y


def read(rec):
    return y.roofline(rec, "k2") if rec.get("section") == "eval" else None
