"""Nothing under portbench/ imports JAX or the JAX package, and nothing
of the reference imports the port: top-level module names compared
whole, since the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "x264vfw_tpu"}


def _files(folder):
    for dirpath, _, names in os.walk(folder):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def _top_names(path):
    """Top-level names of the absolute imports in a file, and whether it
    has a relative import that climbs out of its folder."""
    tree = ast.parse(open(path).read(), path)
    names, climbs = set(), False
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            elif node.level > 1:
                climbs = True
    return names, climbs


@pytest.mark.parametrize("path", sorted(_files(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    names, _ = _top_names(path)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


@pytest.mark.parametrize(
    "path", sorted(_files(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_stands_alone(path):
    names, climbs = _top_names(path)
    assert "x264vfw_tpu_torch" not in names
    assert "torch" not in names
    assert not climbs, f"{path} imports from outside the reference"


def test_top_level_names_are_compared_whole():
    names, _ = _top_names(os.path.join(BENCH, "run.py"))
    assert "x264vfw_tpu_torch" in names
    assert not names & FORBIDDEN


def test_what_a_run_loads():
    """Every module a run imports, the port's among them, in a fresh
    process: none is JAX or the JAX package."""
    code = (
        "import sys, os\n"
        "sys.argv = ['run']\n"
        "from portbench import run, spec, check, trace, generate, roofline\n"
        "import x264vfw_tpu_torch.api\n"
        "from x264vfw_tpu_torch.ops.kernels import sad, memc, deblock\n"
        "from x264vfw_tpu_torch.encode import pipeline, lookahead\n"
        "spec.rooflines()\n"
        "c = spec.load('live1080.vfzl.inter')\n"
        "for m in os.listdir(os.path.join(spec.HERE, 'metrics')):\n"
        "    c.reader(m[:-3])\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    root = os.path.dirname(BENCH)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    assert "x264vfw_tpu_torch" in out
    assert not set(out) & FORBIDDEN
