"""device_idle.train: 1 minus the union of device-operation intervals over
the traced window, in %."""
from nerfbench import yardstick as y


def read(rec):
    return y.idle(rec) if rec.get("section") == "train" else None
