"""train_examples_per_s: every example of the window's training steps
over the window's time (host clock, synchronised at its ends)."""


def read(rec):
    if not rec.get("examples"):
        return None
    return rec["examples"] / rec["window_s"]
