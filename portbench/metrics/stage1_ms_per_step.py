"""stage1_ms_per_step: the SMPL-T fit's seconds (the summary's stage1)
over its Adam steps (fit_smplt's traces; the stage-2 refit left out),
in ms."""


def read(rec):
    ss, steps = rec.get("stage_seconds", {}), rec.get("stage1_steps", 0)
    if not steps:
        return None
    return 1e3 * ss["stage1"] / steps
