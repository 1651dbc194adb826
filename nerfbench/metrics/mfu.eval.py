"""mfu.eval: the model FLOPs of the frames completed (nominal: every K
slot, real rays) over the traced window at the configuration's product
peak, in %."""
from nerfbench import yardstick as y


def read(rec):
    return (y.mfu(rec, rec["cfg"], 1.0) if rec.get("section") == "eval"
            else None)
