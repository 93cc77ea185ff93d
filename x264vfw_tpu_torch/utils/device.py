"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The CUDA device unless the caller names another one.

    Raises when CUDA is asked for (explicitly or by default) and there is
    no card: the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def resolve_devices(devices=None) -> list[torch.device]:
    """The device list of a GOP-parallel encode: every visible CUDA device
    unless the caller names a list (the same device may appear more than
    once: its GOPs then run one after another).

    A CUDA device without an index becomes the current one, so that
    "cuda" and "cuda:0" name the same card.  Raises as resolve_device
    does when a CUDA device is named and there is no card."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("an empty device list")
    return out
