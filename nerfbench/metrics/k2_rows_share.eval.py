"""k2_rows_share.eval: the rows K2's tiles held (`k2.rows`, padding in)
over the neighbour slots the shading layer covers (`shade.rows`), summed
over the frames the spans recorded, in %. None where no recorded frame
counts `k2.rows`: a program without the counter, or frames without K2."""
from nerfbench import stages


def read(rec):
    if stages.frames(rec) is None:
        return None
    from sgnerf_tpu_torch.utils import spans
    groups = [g for g in spans.summary()["groups"]
              if g["kind"] == "frame" and stages.frame_stages(g) is not None]
    held = sum(g["counters"].get("k2.rows", 0) for g in groups)
    rows = sum(g["counters"].get("shade.rows", 0) for g in groups)
    if not any("k2.rows" in g["counters"] for g in groups) or not rows:
        return None
    return 100.0 * held / rows
