"""frame_ms_p90: the 90th percentile of every frame's host-clock time,
from the call to the colours on the host, over all frames of the window."""
import numpy as np


def read(rec):
    if rec.get("section") != "eval":
        return None
    return float(np.percentile(np.asarray(rec["frame_s"]) * 1e3, 90))
