"""frame_edge_ms.eval: a frame's `sgnerf.frame` host time less the device
interval from its first chunk's start to its last chunk's end (upload,
readback, the host before the first chunk reaches the card), the median
over the frames the spans recorded, in ms."""
from nerfbench import stages


def read(rec):
    return stages.median(rec, "edge")
