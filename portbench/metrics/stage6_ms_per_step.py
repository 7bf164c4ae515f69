"""stage6_ms_per_step: the stage-6 joint fit's seconds (the summary's
stage6a + stage6b, synchronised laps) over its Adam steps (the lengths
of the loss traces its SMPL and object fits return), in ms."""


def read(rec):
    ss, steps = rec.get("stage_seconds", {}), rec.get("stage6_steps", 0)
    if not steps:
        return None
    return 1e3 * (ss["stage6a"] + ss["stage6b"]) / steps
