"""Set-up: from the process's start (imports, weights drawn on the card,
the engine built, kernels loaded or built) through the warm-up, until the
window opens; host clock."""


def read(rec):
    return rec["setup_s"]
