"""setup_s: from the process's start (imports, the card, the frame ring,
the session, the kernels' builds on a first run) to the window's start,
the warm-up frames included."""


def read(run):
    return run.setup_s
