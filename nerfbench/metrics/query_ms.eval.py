"""query_ms.eval: a frame's device time in raygen + query (its chunks'
`sgnerf.query` spans: ray samples, sample mask, compaction, cache-row
gather, K1), the median over the frames the spans recorded, in ms."""
from nerfbench import stages


def read(rec):
    return stages.median(rec, "query")
