"""k3_roofline.train: K3's share of its roofline (operations-bound:
block1's data and weight gradients) over the traced window."""
from nerfbench import yardstick as y


def read(rec):
    return y.roofline(rec, "k3") if rec.get("section") == "train" else None
