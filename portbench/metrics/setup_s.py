"""setup_s: from the process's start to the window's: imports, inputs
and weights made from the seed, kernel builds, warm-up."""


def read(rec):
    return rec.get("setup_s")
