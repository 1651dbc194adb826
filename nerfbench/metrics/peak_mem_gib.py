"""peak_mem_gib: torch.cuda.max_memory_allocated over set-up and the
window, in GiB."""


def read(rec):
    b = rec.get("memory_peak_bytes") or 0
    return b / 2 ** 30 if b > 0 else None
