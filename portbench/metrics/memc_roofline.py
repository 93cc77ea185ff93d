"""memc_roofline: the memc kernel's share of its roofline in the traced
window (rooflines/memc.py against rooflines/peaks.py)."""

from portbench.roofline import share


def read(run):
    return share(run, "memc")
