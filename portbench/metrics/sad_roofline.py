"""sad_roofline: the sad kernel's share of its roofline in the traced
window (rooflines/sad.py against rooflines/peaks.py)."""

from portbench.roofline import share


def read(run):
    return share(run, "sad")
