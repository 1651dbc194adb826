"""shade_ms.eval: a frame's device time in shading (its chunks'
`sgnerf.shade` spans: table step, attribute gather, aggregation by K2 or
the un-fused MLPs, colour head, march), the median over the frames the
spans recorded, in ms."""
from nerfbench import stages


def read(rec):
    return stages.median(rec, "shade")
