"""Carry an encoder's state over from the JAX package.

The encoder has no learned weights: what crosses is its configuration and
its decoded picture buffer.  Both arrive as plain Python values and numpy
arrays, so nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

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
    wp_prev: np.ndarray | None = None   # weight analysis: the pooled
    #                                     previous input luma (_wp_prev)
    scenecut_prev: np.ndarray | None = None   # SceneCut.prev
    scenecut_ema: float | None = None         # SceneCut._ema
    # with B frames: the frames waiting for the next anchor, as (y, u, v,
    # display index) numpy planes, the last anchor's colocated field (n,
    # 2), and the display index of the next frame (None: frame_idx)
    pending: list = field(default_factory=list)
    last_mv: np.ndarray | None = None
    display_idx: int | None = None
    # with --ref > 1: the decoded picture buffer, (y, u, v) int32 device
    # planes per reference in ref_idx order (newest first; ref is dpb[0])
    dpb: list = field(default_factory=list)


def state_from_numpy(ref_y: np.ndarray, ref_u: np.ndarray, ref_v: np.ndarray,
                     frame_idx: int, poc: int = 0, frame_num: int | None = None,
                     idr_id: int = 1, last_idr: int = 0, poc_base: int = 0,
                     wp_prev=None, scenecut_prev=None, scenecut_ema=None,
                     pending=(), last_mv=None, display_idx=None,
                     dpb=(), device=None) -> EncoderState:
    """Decoded picture buffer + frame counters from numpy arrays.

    ref_* are the reconstructed reference planes at MB-multiple size, as
    the JAX encoder keeps them (TpuEncoder.ref); with --ref > 1, dpb is
    its DPB (TpuEncoder.dpb: (y, u, v) per reference, newest first, the
    first equal to ref_*).  frame_num defaults to
    frame_idx - last_idr (frames since the IDR, no B frames).  wp_prev is
    the JAX encoder's _wp_prev (--weightp), scenecut_prev and
    scenecut_ema its scene-cut detector's prev and _ema (--scenecut).
    With B frames: pending is the JAX encoder's pending list ((y, u, v,
    display index) each), last_mv its last_mv and display_idx its
    display_idx."""
    dev = resolve_device(device)

    def planes(y, u, v):
        out = tuple(torch.as_tensor(np.asarray(p, np.int32), device=dev)
                    for p in (y, u, v))
        H, W = out[0].shape
        if H % 16 or W % 16 or tuple(out[1].shape) != (H // 2, W // 2) \
                or out[2].shape != out[1].shape:
            raise ValueError("reference planes must be 4:2:0 at MB-multiple "
                             f"size, got {[tuple(p.shape) for p in out]}")
        return out

    ref = planes(ref_y, ref_u, ref_v)
    dpb = [planes(*r) for r in dpb]
    if dpb and not all(torch.equal(a, b) for a, b in zip(dpb[0], ref)):
        raise ValueError("dpb[0] must be the reference planes ref_*")
    if any(r[0].shape != ref[0].shape for r in dpb):
        raise ValueError("the DPB's planes differ in size from ref_*")
    return EncoderState(
        ref=ref, dpb=dpb, frame_idx=frame_idx,
        frame_num=frame_idx - last_idr if frame_num is None else frame_num,
        idr_id=idr_id, poc=poc, last_idr=last_idr, poc_base=poc_base,
        wp_prev=None if wp_prev is None else np.asarray(wp_prev, np.float32),
        scenecut_prev=(None if scenecut_prev is None
                       else np.asarray(scenecut_prev, np.float32)),
        scenecut_ema=None if scenecut_ema is None else float(scenecut_ema),
        pending=[(*(np.asarray(p, np.uint8) for p in f[:3]), int(f[3]))
                 for f in pending],
        last_mv=None if last_mv is None else np.asarray(last_mv, np.int32),
        display_idx=None if display_idx is None else int(display_idx))
