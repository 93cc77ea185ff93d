"""The one traffic generator: a seamless ring of I420 frames from --seed.

After bench.make_clip (bench.py at commit 2e9322e), rewritten without JAX
and made periodic: a smooth luma base that stays still, plus a random
texture that pans by a constant (dx, dy) per frame, and chroma that pans
with it.  The texture repeats every ring * dx columns and ring * dy rows,
so frame `ring` equals frame 0 and the ring wraps without a jump that an
encoder could take for a scene cut.

The texture is drawn from the traffic's own "texture_seed", so every run
of a mix codes the same frames and the same amount of work; --seed draws
the frame the ring starts at, so runs of different seeds code those
frames in another order: the seed changes the order of the work, not
the work.  The frames are made on the device with a seeded
torch.Generator, in a few large calls, and pulled to host memory once,
before the window: compress() takes host planes, as a capture loop or a
file reader hands them over.
"""

from __future__ import annotations

import math
import random

import numpy as np


def _period(step: int, ring: int, size: int) -> int:
    """Period of the texture along one axis: ring * |step| when the
    texture moves along it, else the frame's own size."""
    return ring * abs(step) if step else size


def make_ring(frames: dict, width: int, height: int, seed: int,
              device="cpu") -> list:
    """frames: the traffic file's "frames" entry (ring, dx, dy, the
    texture's seed and amplitude, the base's sinusoids, the chroma's
    amplitude).  Returns `ring` (y, u, v) tuples of contiguous uint8 numpy
    planes, the first of them the one that `seed` draws."""
    import torch

    ring, dx, dy = int(frames["ring"]), int(frames["dx"]), int(frames["dy"])
    amp = int(frames["amplitude"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(frames["texture_seed"]))
    px, py = _period(dx, ring, width), _period(dy, ring, height)
    tile = torch.randint(-amp, amp + 1, (py, px), generator=gen,
                         device=device, dtype=torch.int16)
    reps = (math.ceil((height + py) / py), math.ceil((width + px) / px))
    tex = tile.repeat(*reps)
    yy = torch.arange(height, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(width, device=device, dtype=torch.float64)[None, :]
    b = frames["base"]
    base = (b["mean"] + b["ax"] * torch.sin(xx / b["wx"])
            + b["ay"] * torch.cos(yy / b["wy"]))
    cy = torch.arange(0, height, 2, device=device,
                      dtype=torch.float64)[:, None]
    cx = torch.arange(0, width, 2, device=device,
                      dtype=torch.float64)[None, :]
    ca = float(frames["chroma_amplitude"])
    start = random.Random(int(seed)).randrange(ring)
    out = []
    for f in range(start, start + ring):
        # the texture under pixel (y, x) at frame f is tile[y - f*dy,
        # x - f*dx]: content moves right by dx and down by dy per frame
        oy = (-f * dy) % py
        ox = (-f * dx) % px
        y = base + tex[oy:oy + height, ox:ox + width]
        # chroma moves with the texture, over the texture's periods
        ph = (2 * math.pi * (cx - f * dx) / px
              + 2 * math.pi * (cy - f * dy) / py)
        pw = (2 * math.pi * (cx - f * dx) / px
              - 2 * math.pi * (cy - f * dy) / py)
        u = 128 + ca * torch.sin(ph)
        v = 128 + ca * torch.cos(pw)
        out.append(tuple(p.round().clamp(0, 255).to(torch.uint8)
                         for p in (y, u, v)))
    return [tuple(np.ascontiguousarray(p.cpu().numpy()) for p in fr)
            for fr in out]
