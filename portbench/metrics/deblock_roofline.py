"""deblock_roofline: the deblock kernel's share of its roofline in the traced
window (rooflines/deblock.py against rooflines/peaks.py)."""

from portbench.roofline import share


def read(run):
    return share(run, "deblock")
