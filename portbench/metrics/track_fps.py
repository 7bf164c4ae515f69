"""track_fps: every frame of the window's whole `track` calls over their
summed wall time (host clock, each call synchronised)."""


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["frames"] / rec["call_seconds"]
