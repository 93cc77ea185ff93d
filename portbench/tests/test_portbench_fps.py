"""fps and frame_ms_p95 follow their definitions on a made-up timeline."""

import types

import numpy as np
import pytest

from portbench import spec

CELL = spec.load("live1080.vfzl.inter")


def _run(calls, t0=10.0):
    return types.SimpleNamespace(calls=calls, t0=t0)


def test_fps_counts_whole_frames_to_the_last_return():
    # (start, end, frames, counted): three frames counted, the call that
    # straddles the window's end neither counted nor timed
    calls = [(10.0, 10.5, 1, True), (10.5, 11.25, 1, True),
             (11.25, 12.0, 1, True), (12.0, 13.5, 1, False)]
    assert CELL.reader("fps").read(_run(calls)) == pytest.approx(3 / 2.0)


def test_fps_of_delayed_returns():
    # the batched path: calls return nothing, then a window of 12 frames
    calls = ([(10.0 + i, 11.0 + i, 0, True) for i in range(11)]
             + [(21.0, 22.0, 12, True), (22.0, 23.0, 0, True)])
    assert CELL.reader("fps").read(_run(calls)) == pytest.approx(12 / 12.0)


def test_fps_without_a_returned_frame_is_missing():
    calls = [(10.0, 60.0, 1, False)]
    assert CELL.reader("fps").read(_run(calls)) is None


def test_frame_ms_p95_is_the_95th_percentile_of_counted_calls():
    ms = np.arange(1, 101, dtype=float)
    calls = [(0.0, m / 1e3, 1, True) for m in ms] + [(0.0, 9.0, 1, False)]
    got = CELL.reader("frame_ms_p95").read(_run(calls))
    assert got == pytest.approx(float(np.percentile(ms, 95)))
