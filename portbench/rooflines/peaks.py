"""The table of peaks a kernel's roofline share is taken against.

Frozen from chip_smoke.py at commit cc6a3ed (PEAK_BYTES,
INT32_LANES_PER_SM and sad_int_bound_ms's rate; unchanged at 4a379f6).
HBM bandwidth is NVIDIA's published figure for the H100 SXM (80 GB HBM3).
The port's kernels do their arithmetic on the int32 pipes, not on the
tensor cores, so every operation count goes against the int32 rate: 64
lanes per SM per clock on Hopper, over the card's SMs at its highest SM
clock, both read from the card at run time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def int32_ops_per_s(sms: int, clock_hz: float) -> float:
    return sms * INT32_LANES_PER_SM * clock_hz


def bound_s(nbytes: float, int_ops: float, sms: int, clock_hz: float):
    """Least time in seconds: bytes over HBM bandwidth or int32 operations
    over the int32 rate, the larger; and which of the two it is."""
    tb = nbytes / HBM_BYTES_PER_S
    to = int_ops / int32_ops_per_s(sms, clock_hz)
    return (tb, "bytes") if tb >= to else (to, "operations")
