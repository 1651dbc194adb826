"""shade_fill.eval: the share of the neighbour slots the shading layer
computes that hold a neighbour (`shade.found` over `shade.rows`, summed
over the frames the spans recorded), in %."""
from nerfbench import stages


def read(rec):
    fs = stages.frames(rec)
    if fs is None:
        return None
    rows = sum(f["rows"] for f in fs)
    return 100.0 * sum(f["found"] for f in fs) / rows if rows else None
