"""`correct` holds for a sound run and comes out false with the timed path
broken underneath (the step 3 faults of an encoder, and a chroma-only
fault: no chroma residual coded in P macroblocks) and for the control,
the same encoder at --crf 29: a quantiser step twice as coarse as the
configuration's --crf 23 states.  CPU, 320x192, each cell's own limits;
the `chip` test repeats the control at the cell's own size on the card."""

import io
import json
import os

import pytest

from portbench import spec
from portbench.reference.h264.nal import START_CODE_LONG, iter_annexb_raw
from portbench.run import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
SIZE = (320, 192)


class _Session:
    """Passes every call through, then changes what it returns."""

    def __init__(self, sess):
        self.sess = sess
        self.calls = 0

    def frames_info(self):
        return self.sess.frames_info()

    def compress(self, frame, fmt):
        out = self.sess.compress(frame, fmt)
        self.calls += 1
        return self.change(out)


class StateUnchanged(_Session):
    """From the second call on, every call returns what the one before it
    returned: the encoder's state does not move on."""

    last = b""

    def change(self, out):
        if self.calls > 1 and out:
            out, self.last = self.last, out
            return out
        self.last = out
        return out


class HalfLeftOut(_Session):
    """Every second coded picture is left out of what comes back."""

    seen = 0

    def change(self, out):
        kept = b""
        for raw in iter_annexb_raw(out):
            if raw[0] & 0x1F in (1, 5) and raw[1] & 0x80:
                self.seen += 1
            if self.seen % 2 == 0 and self.seen > 2:
                continue
            kept += START_CODE_LONG + raw
        return kept


class TokenAltered(_Session):
    """One byte in the middle of every slice after the IDR is changed."""

    def change(self, out):
        res = b""
        for raw in iter_annexb_raw(out):
            if raw[0] & 0x1F == 1 and len(raw) > 8:
                k = len(raw) // 2
                raw = raw[:k] + bytes([raw[k] ^ 0x5A]) + raw[k + 1:]
            res += START_CODE_LONG + raw
        return res


def _run(name, wrap=None, extra="", device="cpu", size=SIZE, seed=None):
    cell = spec.load(name)
    log = io.StringIO()
    res = run_cell(cell, seed or 2**31 + 101, 3.0, False, device=device,
                   size=size, extra_cmdline=extra, wrap=wrap, log=log,
                   workers=0)
    return res, log.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, log = _run(name)
    assert res["correct"], log


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [StateUnchanged, HalfLeftOut,
                                   TokenAltered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(name, fault):
    res, log = _run(name, wrap=fault)
    assert not res["correct"], log


def _zero_chroma_residual(monkeypatch):
    """The encoder codes no chroma residual in P macroblocks: their chroma
    levels come out zero and the reconstruction follows them, so the
    stream stays valid and its luma is untouched."""
    from x264vfw_tpu_torch.encode import device

    orig = device._chroma_residual_pipeline

    def zeroed(src_c8, pred_c8, qpc, intra, qp_dc=None):
        dc, ac = orig(src_c8, pred_c8, qpc, intra, qp_dc)
        return (dc, ac) if intra else (dc * 0, ac * 0)

    monkeypatch.setattr(device, "_chroma_residual_pipeline", zeroed)


@pytest.mark.parametrize("name", CELLS)
def test_chroma_fault_is_not_correct(name, monkeypatch):
    """mse_chroma_max fails it, where the luma's mse_max cannot."""
    _zero_chroma_residual(monkeypatch)
    res, log = _run(name)
    assert not res["correct"], log
    numbers = res["compared"]
    assert numbers["stream_faults"]["value"] == 0
    assert numbers["mse_max"]["value"] <= numbers["mse_max"]["limit"], log
    assert (numbers["mse_chroma_max"]["value"]
            > numbers["mse_chroma_max"]["limit"]), log


def _control(name):
    return spec.load(name).config["control"]["cmdline"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res, log = _run(name, extra=_control(name))
    assert not res["correct"], log
    assert res["compared"]["stream_faults"]["value"] == 0


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    """The control at the cell's own size: --crf 29 fails mse_max."""
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        res, log = _run(name, extra=_control(name), device=card, size=None,
                        seed=seed)
        assert not res["correct"], log
