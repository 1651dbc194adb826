"""K1's function: for each shading point, the K nearest of its voxel's C
cache candidates within the radius. Counted from the frames' own samples
(the eval driver's census, from the reference's sample selection): each
distinct voxel's cache row read once a frame (C candidates of three
offsets in the cache's precision and an int32 id), each shading point's
position (three float32) read and its K int32 ids written; operations: 8
a candidate (three differences, three squares, two sums) on the CUDA
cores. A kernel that reads a row once a shading point, or visits empty
sample slots, does more than the function needs: its share reads lower.
No census, no count."""


def count(cfg, rec):
    if "query_points" not in rec:
        return None
    sec = cfg[rec["section"]]
    C, K = int(sec["ref"]["nbr_cache"]), int(cfg["widths"]["K"])
    off = 2 if sec["ref"]["cache_dtype"] == "bfloat16" else 4
    pts, rows = int(rec["query_points"]), int(rec["query_rows"])
    return rows * C * (3 * off + 4) + pts * (12 + K * 4), \
        [(8.0 * pts * C, "fp32")]
