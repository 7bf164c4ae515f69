"""stage4_s_per_frame: SIF-Net's encode and the surface harvest (the
summary's stage4_encode + stage4_harvest) over the frames tracked."""


def read(rec):
    ss = rec.get("stage_seconds", {})
    if not rec.get("frames") or "stage4_encode" not in ss:
        return None
    return (ss["stage4_encode"] + ss["stage4_harvest"]) / rec["frames"]
