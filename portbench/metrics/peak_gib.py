"""peak_gib: torch.cuda.max_memory_allocated over the window, in GiB
(the program's own resets of the peak folded in)."""


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2 ** 30
