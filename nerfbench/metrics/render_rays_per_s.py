"""render_rays_per_s: every ray of the frames completed in the window
over the whole window (host clock; a frame ends with its colours on the
host)."""


def read(rec):
    if rec.get("section") != "eval":
        return None
    return rec["rays"] / rec["window_s"]
