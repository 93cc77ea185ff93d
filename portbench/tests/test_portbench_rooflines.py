"""The benchmark's frozen counts equal chip_smoke.py's for the same
shapes: bytes as chip_smoke counts them, operations as its int32-pipe
count for the SAD and as its own counts for memc and deblock."""

import types

import pytest

from portbench import spec

KERNELS = spec.rooflines()
SHAPES = [(1088, 1920, 16), (96, 128, 4), (2160, 3840, 8)]


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke
    # bound(bytes, operations) -> the counts themselves
    monkeypatch.setattr(chip_smoke, "bound", lambda b, o: (b, o))
    return chip_smoke


@pytest.mark.parametrize("H,W,R", SHAPES)
def test_sad_counts(smoke, monkeypatch, H, W, R):
    import torch
    from portbench.rooflines import peaks
    nbytes, ops = KERNELS["sad"].counts(H, W, R)
    assert nbytes == smoke.sad_bound_ms(H, W, R)[0]
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(smoke, "sm_clock_hz", lambda: 1.98e9)
    want_ms = smoke.sad_int_bound_ms(H, W, R)
    assert ops / peaks.int32_ops_per_s(132, 1.98e9) * 1e3 == \
        pytest.approx(want_ms, rel=1e-12)


@pytest.mark.parametrize("H,W,R", SHAPES)
@pytest.mark.parametrize("sub_lv", [0, 1, 2])
def test_memc_counts(smoke, H, W, R, sub_lv):
    from x264vfw_tpu_torch.ops.kernels.memc import refine_deltas
    ncand = len(refine_deltas(sub_lv))
    assert KERNELS["memc"].candidates(sub_lv) == ncand
    assert KERNELS["memc"].counts(H, W, R, sub_lv) == \
        smoke.memc_bound_ms(H, W, R, ncand)


@pytest.mark.parametrize("H,W,_", SHAPES)
def test_deblock_counts(smoke, H, W, _):
    assert KERNELS["deblock"].counts(H, W) == smoke.deblock_bound_ms(H, W)


def test_the_int32_rate_bounds_the_sad_at_1080p():
    """At 1088x1920 and R = 16 the SAD is bound by its int32 operations,
    about 0.034 ms on 132 SMs at 1.98 GHz."""
    from portbench.rooflines import peaks
    t, which = peaks.bound_s(*KERNELS["sad"].counts(1088, 1920, 16),
                             132, 1.98e9)
    assert which == "operations"
    assert t * 1e3 == pytest.approx(0.0340, abs=0.0005)
