"""mfu.train: forward plus backward model FLOPs (three times the
forward's) of the steps completed over the traced window at the
configuration's product peak, in %."""
from nerfbench import yardstick as y


def read(rec):
    return (y.mfu(rec, rec["cfg"], 3.0) if rec.get("section") == "train"
            else None)
