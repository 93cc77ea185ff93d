"""Whether what the timed path produced is correct.

The session's output is an H.264 stream.  The benchmark's own reference
(reference/h264, a frozen numpy decoder, and reference/psnr.py) judges
it against the frames the benchmark generated, with nothing taken from
the program but the bytes it returned:

* every picture the session returned, warm-up and window alike, is read
  at the level of its headers: the parameter sets and slice headers say
  what the configuration states (its "stream" entry), IDRs fall where
  the traffic's keyint puts them, frame_num runs on without a gap, and
  the pictures' display indices are 0..n-1 once each (nothing lost,
  repeated or reordered), with no fewer than the session's delay allows;
* the chain from the IDR through the traffic's "decode" frames is
  decoded in full, and each decoded picture's three planes are compared
  with its source frame's (mse_max: the worst plane of the worst
  picture);
* a sample of the window's other pictures, drawn from --seed, is parsed
  in full (every macroblock's CABAC syntax to the end of the slice) in
  worker processes, or decoded and compared where it is an IDR.

Two numbers are compared, each with its limit: stream_faults (exact,
limit 0) and mse_max (limits/<cell>.json).  Nothing here imports torch
or the port; the worker processes import only this module's reference.
"""

from __future__ import annotations

import os
import pickle
import random
import subprocess
import sys
import time
from dataclasses import asdict, dataclass, field

import numpy as np

from .reference.h264.bitstream import BitReader, unescape_ebsp
from .reference.h264.decoder import H264Decoder
from .reference.h264.nal import (NAL_PPS, NAL_SLICE, NAL_SLICE_IDR, NAL_SPS,
                                 START_CODE_LONG, iter_annexb_raw)
from .reference.h264.params import PPS, SPS
from .reference.h264.slice import SliceHeader
from .reference.psnr import mse, psnr

#: at most this many fault reasons are kept for the report
MAX_REASONS = 8


@dataclass
class Picture:
    """One coded picture as the session returned it."""
    nals: list                  # raw NAL units (escaped, no start code)
    in_window: bool             # returned by a call counted in the window
    nal_type: int = 0
    nal_ref_idc: int = 0
    slice_type: str = ""
    display: int = -1


@dataclass
class Verdict:
    stream_faults: int = 0
    mse_max: float | None = None     # worst plane of the worst picture
    mse_first: float | None = None   # worst plane of the first picture
    plane_mse_max: list = field(default_factory=list)   # Y, U, V each
    mse_chroma_max: float | None = None   # worst of U and V
    reasons: list = field(default_factory=list)
    window_i_frames: int = 0
    pictures: int = 0
    decoded: int = 0
    sampled: int = 0
    chain_s: float = 0.0        # seconds the chain's decode took
    psnr: dict = field(default_factory=dict)     # display -> luma PSNR
    bytes: dict = field(default_factory=dict)    # display -> AU bytes

    def fault(self, why: str) -> None:
        self.stream_faults += 1
        if len(self.reasons) < MAX_REASONS:
            self.reasons.append(why)


def _nal_rbsp(raw: bytes):
    return unescape_ebsp(np.frombuffer(raw[1:], np.uint8))


def split_pictures(chunks) -> list:
    """chunks: (bytes, call index, in_window) per compress() call, in
    order.  Parameter sets and SEI go with the picture that follows; a
    slice with first_mb_in_slice 0 starts a picture."""
    pics: list[Picture] = []
    pending: list = []
    for data, _, in_window in chunks:
        for raw in iter_annexb_raw(data):
            t = raw[0] & 0x1F
            if t in (NAL_SLICE, NAL_SLICE_IDR):
                if raw[1] & 0x80 or not pics:      # ue(first_mb) == 0
                    pics.append(Picture(nals=pending + [raw],
                                        in_window=in_window))
                    pending = []
                else:
                    pics[-1].nals.append(raw)
            else:
                pending.append(raw)
    return pics


def read_headers(pics: list, keyint, stream: dict, v: Verdict,
                 size=None) -> None:
    """Fill each picture's header fields and display index; count every
    departure from the stream the configuration states, and from the
    frame size (width, height) where given."""
    sps = pps = None
    prev_ref_fn = None
    poc_msb = poc_lsb_prev = 0
    base = 0            # display index of the current IDR
    top = -1            # highest display index so far
    prev_idr_id = None  # idr_pic_id of the picture before, if an IDR
    for k, p in enumerate(pics):
        try:
            for raw in p.nals:
                t = raw[0] & 0x1F
                if t == NAL_SPS:
                    sps = SPS.from_rbsp(_nal_rbsp(raw))
                    _expect(v, "sps", sps, stream.get("sps", {}), k)
                    if size and (sps.width, sps.height) != tuple(size):
                        v.fault(f"picture {k}: a {sps.width}x{sps.height} "
                                f"SPS for {size[0]}x{size[1]} frames")
                elif t == NAL_PPS:
                    pps = PPS.from_rbsp(_nal_rbsp(raw))
                    _expect(v, "pps", pps, stream.get("pps", {}), k)
            head = next(r for r in p.nals
                        if r[0] & 0x1F in (NAL_SLICE, NAL_SLICE_IDR))
            p.nal_type, p.nal_ref_idc = head[0] & 0x1F, (head[0] >> 5) & 3
            if sps is None or pps is None:
                raise ValueError("a slice before its parameter sets")
            h = SliceHeader.parse(BitReader(_nal_rbsp(head)), sps, pps,
                                  p.nal_type, p.nal_ref_idc)
        except Exception as exc:    # a malformed picture is a fault
            v.fault(f"picture {k}: headers unreadable ({exc!r})")
            continue
        p.slice_type = "B" if h.is_b() else ("P" if h.is_p() else "I")
        _expect(v, "slice", h, stream.get("slice", {}), k)
        if p.slice_type == "B" and not stream.get("b_slices", False):
            v.fault(f"picture {k}: a B slice the configuration has none of")
        idr = p.nal_type == NAL_SLICE_IDR
        max_fn = 1 << (sps.log2_max_frame_num_minus4 + 4)
        if idr:
            if h.frame_num != 0:
                v.fault(f"picture {k}: IDR with frame_num {h.frame_num}")
            # two IDRs in a row differ in idr_pic_id (7.4.3)
            if prev_idr_id == h.idr_pic_id:
                v.fault(f"picture {k}: idr_pic_id {h.idr_pic_id} as the "
                        f"IDR before it")
            prev_ref_fn = 0
            poc_msb = poc_lsb_prev = 0
            base = top + 1
        elif prev_ref_fn is None:
            v.fault(f"picture {k}: no IDR before it")
            continue
        else:
            if h.frame_num != (prev_ref_fn + 1) % max_fn:
                v.fault(f"picture {k}: frame_num {h.frame_num} after "
                        f"{prev_ref_fn}")
            if p.nal_ref_idc:
                prev_ref_fn = h.frame_num
        if sps.pic_order_cnt_type == 0:
            max_lsb = 1 << (sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            lsb = h.pic_order_cnt_lsb
            msb = poc_msb
            if lsb < poc_lsb_prev and poc_lsb_prev - lsb >= max_lsb // 2:
                msb += max_lsb
            elif lsb > poc_lsb_prev and lsb - poc_lsb_prev > max_lsb // 2:
                msb -= max_lsb
            if p.nal_ref_idc:
                poc_msb, poc_lsb_prev = msb, lsb
            p.display = base + (msb + lsb) // 2
        else:
            # POC type 2: output order is decode order
            p.display = top + 1 if not idr else base
        top = max(top, p.display)
        prev_idr_id = h.idr_pic_id if idr else None
        want_idr = (p.display == 0 if keyint == "infinite"
                    else p.display % int(keyint) == 0)
        if idr != want_idr:
            v.fault(f"picture {k}: display {p.display} "
                    f"{'is' if idr else 'is not'} an IDR")


def _expect(v: Verdict, what: str, obj, want: dict, k: int) -> None:
    for key, val in want.items():
        got = getattr(obj, key)
        if got != val:
            v.fault(f"picture {k}: {what}.{key} = {got}, the configuration "
                    f"states {val}")


def _annexb(nals) -> bytes:
    return b"".join(START_CODE_LONG + r for r in nals)


def _param_nals(p: Picture, pics: list) -> list:
    """The parameter-set NALs in force for picture p (the last SPS and
    PPS returned before it)."""
    found: dict = {}
    for q in pics:
        for raw in q.nals:
            if raw[0] & 0x1F in (NAL_SPS, NAL_PPS):
                found[raw[0] & 0x1F] = raw
        if q is p:
            break
    return [found[t] for t in (NAL_SPS, NAL_PPS) if t in found]


def decode_and_compare(au: bytes, sources: list) -> list:
    """Decode one self-contained run of pictures against their (y, u, v)
    sources; per picture, in decode order, ((mse of Y, U, V), luma
    psnr)."""
    dec = H264Decoder()
    frames = dec.decode(au)
    if len(frames) != len(sources):
        raise ValueError(f"{len(frames)} pictures decoded of "
                         f"{len(sources)}")
    return [(tuple(mse(a, b) for a, b in zip((f.y, f.u, f.v), s)),
             psnr(f.y, s[0])) for f, s in zip(frames, sources)]


def parse_only(params: list, pic_nals: list) -> int:
    """Parse a CABAC picture's every macroblock without reconstructing
    it; returns the macroblocks read.  Raises where the syntax does not
    end exactly at the last macroblock."""
    from .reference.h264.cabac_slice import CabacSliceReader

    sps = pps = None
    for raw in params:
        if raw[0] & 0x1F == NAL_SPS:
            sps = SPS.from_rbsp(_nal_rbsp(raw))
        elif raw[0] & 0x1F == NAL_PPS:
            pps = PPS.from_rbsp(_nal_rbsp(raw))
    if not pps.entropy_coding_mode_flag:
        raise ValueError("parse_only reads CABAC slices")
    n = sps.mb_width * sps.mb_height
    read = 0
    for raw in pic_nals:
        t = raw[0] & 0x1F
        if t not in (NAL_SLICE, NAL_SLICE_IDR):
            continue
        rbsp = _nal_rbsp(raw)
        r = BitReader(rbsp)
        h = SliceHeader.parse(r, sps, pps, t, (raw[0] >> 5) & 3)
        pad = (-r.bit_position) % 8
        if pad:
            r.u(pad)
        rd = CabacSliceReader(pps.pic_init_qp_minus26 + 26 + h.slice_qp_delta,
                              h.is_i(), sps.mb_height, sps.mb_width,
                              np.asarray(rbsp[r.bit_position // 8:],
                                         np.uint8).tobytes(),
                              h.cabac_init_idc)
        rd.num_ref_l0 = h.num_ref_idx_l0_active_minus1 + 1
        rd.num_ref_l1 = h.num_ref_idx_l1_active_minus1 + 1
        rd.first_mb = h.first_mb_in_slice
        rd.transform_8x8_mode = bool(pps.transform_8x8_mode_flag)
        read_mb = (rd.read_b_mb if h.is_b() else
                   rd.read_p_mb if h.is_p() else rd.read_i_mb)
        for k in range(h.first_mb_in_slice, n):
            read_mb(k % sps.mb_width, k // sps.mb_width)
            read += 1
            if rd.end_mb():
                break
        else:
            raise ValueError("slice data continues past the last MB")
    if read != n:
        raise ValueError(f"{read} of {n} macroblocks in the picture")
    return read


def _sample_job(job):
    """Worker: ("decode", au, source), ("parse", params, nals) or
    ("judge", judge's arguments), the last for readings.py."""
    kind = job[0]
    try:
        if kind == "judge":
            return ("ok", asdict(judge(*job[1:7], workers=0, size=job[7])))
        if kind == "decode":
            return ("ok", decode_and_compare(job[1], [job[2]])[0])
        return ("ok", parse_only(job[1], job[2]))
    except Exception as exc:        # reported as a fault by the caller
        return ("error", repr(exc))


def judge(chunks, ring: list, traffic: dict, stream: dict, seed: int,
          min_returned: int, workers: int = 0, size=None) -> Verdict:
    """chunks: what each compress() call returned, in order; ring: the
    source frames as (y, u, v) planes, display index i is
    ring[i % len(ring)]; min_returned:
    the fewest pictures the session may have returned (frames pushed less
    its delay); size: the frames' (width, height)."""
    v = Verdict()
    pics = split_pictures(chunks)
    v.pictures = len(pics)
    read_headers(pics, traffic["keyint"], stream, v, size)
    shown = sorted(p.display for p in pics if p.display >= 0)
    if shown != list(range(len(pics))):
        v.fault(f"display indices are not 0..{len(pics) - 1} once each")
    if len(pics) < min_returned:
        v.fault(f"{len(pics)} pictures returned, {min_returned} due")
    v.window_i_frames = sum(1 for p in pics
                            if p.in_window and p.slice_type == "I")
    if traffic["keyint"] == "infinite" and v.window_i_frames:
        v.fault(f"{v.window_i_frames} I pictures in the window")
    for p in pics:
        if p.display >= 0:
            v.bytes[p.display] = sum(len(r) + 4 for r in p.nals)

    # the chain: every picture in decode order up to the last one shown
    # before decode["frames"]; non-reference pictures only from
    # decode["nonref_from"] on
    dec = traffic["decode"]
    last = max((k for k, p in enumerate(pics)
                if 0 <= p.display < dec["frames"]), default=-1)
    chain = [p for p in pics[:last + 1]
             if p.nal_ref_idc or p.display >= dec.get("nonref_from", 0)]
    chain_ids = {id(p) for p in chain}
    rest = [p for p in pics if p.in_window and id(p) not in chain_ids
            and p.display >= 0]
    rng = random.Random(seed)
    sample = rng.sample(rest, min(len(rest), int(traffic.get("sample", 0))))
    jobs = []
    for p in sample:
        if p.nal_type == NAL_SLICE_IDR:
            jobs.append(("decode", _annexb(_param_nals(p, pics) + [
                r for r in p.nals if r[0] & 0x1F not in (NAL_SPS, NAL_PPS)]),
                ring[p.display % len(ring)]))
        else:
            jobs.append(("parse", _param_nals(p, pics),
                         [r for r in p.nals
                          if r[0] & 0x1F in (NAL_SLICE, NAL_SLICE_IDR)]))
    procs = start_workers(jobs, workers)
    try:
        errors = []
        t = time.perf_counter()
        if chain:
            try:
                res = decode_and_compare(
                    _annexb([r for p in chain for r in p.nals]),
                    [ring[p.display % len(ring)] for p in chain])
            except Exception as exc:
                v.fault(f"the chain of {len(chain)} pictures does not "
                        f"decode ({exc!r})")
                res = []
            v.decoded = len(res)
            for p, (m, ps) in zip(chain, res):
                errors.append(m)
                v.psnr[p.display] = ps
        v.chain_s = time.perf_counter() - t
    finally:
        results = finish_workers(procs, jobs)
    for p, job, (status, out) in zip(sample, jobs, results):
        v.sampled += 1
        if status != "ok":
            v.fault(f"display {p.display}: {job[0]} failed ({out})")
        elif job[0] == "decode":
            errors.append(out[0])
            v.psnr[p.display] = out[1]
    if errors:
        v.plane_mse_max = [max(e[c] for e in errors) for c in range(3)]
        v.mse_max = max(v.plane_mse_max)
        v.mse_chroma_max = max(v.plane_mse_max[1:])
    if chain and v.decoded and chain[0].display == 0:
        v.mse_first = max(errors[0])
    return v


def start_workers(jobs: list, workers: int) -> list:
    """Start up to `workers` processes (python -m portbench.check), each
    handed its share of the jobs on its standard input; none where
    workers is 0 (the jobs then run here)."""
    if not jobs or workers <= 0:
        return []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    n = min(workers, len(jobs))
    for k in range(n):
        p = subprocess.Popen([sys.executable, "-m", "portbench.check"],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             cwd=root, env=env)
        p.stdin.write(pickle.dumps(jobs[k::n]))
        p.stdin.close()
        procs.append(p)
    return procs


def finish_workers(procs: list, jobs: list) -> list:
    """Each job's (status, result), in the jobs' order; waits for every
    worker to end."""
    if not procs:
        return [_sample_job(j) for j in jobs]
    parts = []
    for p in procs:
        out = p.stdout.read()
        p.stdout.close()
        rc = p.wait()
        parts.append(pickle.loads(out) if rc == 0 and out else None)
    results = []
    for i in range(len(jobs)):
        part = parts[i % len(procs)]
        results.append(part[i // len(procs)] if part is not None
                       else ("error", "its worker process failed"))
    return results


def default_workers() -> int:
    """Worker processes for the sample: half the host's cores, which
    leaves the chain's decode a core of its own, at most 4."""
    return max(1, min(4, (os.cpu_count() or 2) // 2))


if __name__ == "__main__":
    # a worker: jobs from standard input, their results to standard output
    todo = pickle.loads(sys.stdin.buffer.read())
    sys.stdout.buffer.write(pickle.dumps([_sample_job(j) for j in todo]))
