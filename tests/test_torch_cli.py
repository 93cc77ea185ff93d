"""The rest of the session surface: the port's command line
(x264vfw_tpu_torch/cli.py), --threads N on one device and config
persistence, against the JAX package.

* The CLI reads raw I420 (.yuv with --input-res) and Y4M (its geometry and
  frame rate from the header), stops after --frames, and writes the
  container -o names.  Its .mp4 (from .yuv) and .mkv (from .y4m) files
  equal, byte for byte, the files a JAX CompressSession writes from the
  same frames with the same options (committed in tests/jax_refs/
  surface.npz; JAX's own cli.main is not called, since it turns on the
  XLA compilation cache).  main(argv, device="cpu") runs it here; without
  a device argument it runs on the card.
* --threads 2 and --threads 4: a port session owns one device, so it
  batches as the JAX package does on one device; its bytes equal the JAX
  session with threads=0 (tests/jax_refs/l3.npz, x264's --preset
  ultrafast --crf 23 over two windows and a flush).
* config/persist.py writes the JSON file the JAX package writes and loads
  it back.
"""

import json

import pytest

import torch_jax_refs
import test_torch_pipeline as tpl
from test_torch_session import moving_clip
from x264vfw_tpu.config import persist as jax_persist
from x264vfw_tpu.config.options import fullhelp as jax_fullhelp
from x264vfw_tpu_torch import cli
from x264vfw_tpu_torch.api import CompressSession
from x264vfw_tpu_torch.config import persist
from x264vfw_tpu_torch.config.options import parse_cmdline

W, H = 64, 48
# name -> (options, input kind, frames in the file, --frames, Y4M rate)
CLI_CASES = {
    "mp4": (["--preset", "ultrafast"], "yuv", 5, None, None),
    "mkv": (["--preset", "ultrafast", "--tune", "zerolatency", "--qp", "26"],
            "y4m", 5, 4, (30, 1)),
}


def cli_frames(name):
    """The frames of the case's input file."""
    return moving_clip(W, H, CLI_CASES[name][2], seed=21)


def write_input(name, path):
    """The case's input file: raw I420 or Y4M (C420jpeg)."""
    _, kind, _, _, fps = CLI_CASES[name]
    with open(path, "wb") as f:
        if kind == "y4m":
            f.write(f"YUV4MPEG2 W{W} H{H} F{fps[0]}:{fps[1]} Ip A1:1 "
                    "C420jpeg\n".encode())
        for y, u, v in cli_frames(name):
            if kind == "y4m":
                f.write(b"FRAME\n")
            f.write(y.tobytes() + u.tobytes() + v.tobytes())


def cli_argv(name, inp, out):
    opts, kind, _, limit, _ = CLI_CASES[name]
    return (opts + (["--input-res", f"{W}x{H}"] if kind == "yuv" else [])
            + (["--frames", str(limit)] if limit else []) + ["-o", out, inp])


def session_file(make_session, parse, name, path):
    """The file a CompressSession (make_session(params)) writes with the
    case's options from the frames the CLI reads: how
    tools/make_torch_jax_refs.py writes the JAX package's."""
    opts, _, _, limit, fps = CLI_CASES[name]
    params, _ = parse(opts)
    if fps:
        params.fps_num, params.fps_den = fps
    s = make_session(params)
    s.begin(W, H, output=path)
    for f in cli_frames(name)[:limit]:
        s.compress(f)
    s.end()
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_refs():
    return torch_jax_refs.load("surface")


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_file_equals_jax_session(jax_refs, tmp_path, name):
    kind = CLI_CASES[name][1]
    inp, out = str(tmp_path / f"in.{kind}"), str(tmp_path / f"out.{name}")
    write_input(name, inp)
    assert cli.main(cli_argv(name, inp, out), device="cpu") == 0
    with open(out, "rb") as f:
        got = f.read()
    assert got == jax_refs[f"cli_{name}"].tobytes()
    # and the port's own session writes the same file
    assert got == session_file(lambda p: CompressSession(p, device="cpu"),
                               parse_cmdline, name,
                               str(tmp_path / f"session.{name}"))


def test_cli_help_and_usage(capsys):
    assert cli.main(["--fullhelp"], device="cpu") == 0
    assert capsys.readouterr().out == jax_fullhelp() + "\n"
    assert cli.main(["--preset", "ultrafast"], device="cpu") == 2
    assert "usage" in capsys.readouterr().err


@pytest.mark.parametrize("threads", [2, 4])
def test_threads_on_one_device_equal_jax(threads):
    """--threads N > 1 is neither refused nor sharded: the session batches
    and writes the JAX one-device bytes."""
    refs = torch_jax_refs.load("l3")
    s = CompressSession(extra_cmdline=f"{tpl.L3} --crf 23 --threads "
                        f"{threads}", device="cpu")
    outs, tail, delay = tpl.run(s)
    assert s._pipe is not None and s.params.threads == threads
    assert outs == torch_jax_refs.aus(refs, "crf23_out")
    assert tail == refs["crf23_tail"].tobytes()
    assert delay == int(refs["crf23_delay"])


def test_persist_round_trip(tmp_path):
    p, _ = parse_cmdline("--preset slow --crf 20 --psnr --threads 3")
    path = str(tmp_path / "cfg" / "config.json")
    persist.save(p, path)
    q, warns = persist.load(path)
    assert q == p and warns == []
    jp, _ = jax_persist.load(path)          # the JAX package reads it too
    jax_path = str(tmp_path / "jax.json")
    jax_persist.save(jp, jax_path)
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    missing, warns = persist.load(str(tmp_path / "none.json"))
    assert missing == type(p)() and warns == []
    with open(path, "w") as f:
        f.write("{not json")
    bad, warns = persist.load(path)
    assert bad == type(p)() and len(warns) == 1
    assert json.loads(json.dumps(p.to_dict())) == p.to_dict()
