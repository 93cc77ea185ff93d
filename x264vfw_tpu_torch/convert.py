"""Carry an encoder's state over from the JAX package.

The encoder has no learned weights: what crosses is its configuration and
its decoded picture buffer.  Both arrive as plain Python values and numpy
arrays, so nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .encode.ref_encoder import EncoderConfig
from .utils.device import resolve_device


def config_from_jax_fields(d: dict) -> EncoderConfig:
    """EncoderConfig from the field dict of the JAX package's EncoderConfig
    (dataclasses.asdict of it).  Unknown fields raise."""
    names = {f.name for f in dataclasses.fields(EncoderConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown EncoderConfig fields: {sorted(extra)}")
    return EncoderConfig(**d)


@dataclass
class EncoderState:
    """The per-stream state of TorchEncoder between two frames."""
    ref: tuple            # (y, u, v) int32 device planes, MB-multiple size
    frame_idx: int        # frames encoded so far
    frame_num: int        # frame_num of the next frame
    idr_id: int           # idr_pic_id of the next IDR
    poc: int = 0          # pic_order_cnt_lsb of the next frame
    last_idr: int = 0     # display index of the last IDR
    poc_base: int = 0     # display index the POC counts from (the batched
    #                       session sets it at each IDR)


def state_from_numpy(ref_y: np.ndarray, ref_u: np.ndarray, ref_v: np.ndarray,
                     frame_idx: int, poc: int = 0, frame_num: int | None = None,
                     idr_id: int = 1, last_idr: int = 0, poc_base: int = 0,
                     device=None) -> EncoderState:
    """Decoded picture buffer + frame counters from numpy arrays.

    ref_* are the reconstructed reference planes at MB-multiple size, as
    the JAX encoder keeps them (TpuEncoder.ref).  frame_num defaults to
    frame_idx - last_idr (frames since the IDR, no B frames)."""
    dev = resolve_device(device)
    ref = tuple(torch.as_tensor(np.asarray(p, np.int32), device=dev)
                for p in (ref_y, ref_u, ref_v))
    H, W = ref[0].shape
    if H % 16 or W % 16 or tuple(ref[1].shape) != (H // 2, W // 2) \
            or ref[2].shape != ref[1].shape:
        raise ValueError("reference planes must be 4:2:0 at MB-multiple size, "
                         f"got {[tuple(p.shape) for p in ref]}")
    return EncoderState(
        ref=ref, frame_idx=frame_idx,
        frame_num=frame_idx - last_idr if frame_num is None else frame_num,
        idr_id=idr_id, poc=poc, last_idr=last_idr, poc_base=poc_base)
