"""inputs_s_per_frame: the host inputs (the summary's inputs: reads,
crops and resizes, every pass) over the frames tracked."""


def read(rec):
    ss = rec.get("stage_seconds", {})
    if not rec.get("frames") or "inputs" not in ss:
        return None
    return ss["inputs"] / rec["frames"]
