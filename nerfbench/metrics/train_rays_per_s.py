"""train_rays_per_s: the rays of every step completed in the window over
the whole window, which ends at a synchronise."""


def read(rec):
    if rec.get("section") != "train":
        return None
    return rec["rays"] / rec["window_s"]
