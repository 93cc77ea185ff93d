"""Every module and public name of the JAX package has its counterpart in
the port, or a stated reason why it has none.

Both packages are read with ast; neither is imported.  A public name is a
top-level def, class or assignment of a module of x264vfw_tpu/ whose name
does not start with "_", and, for a class whose counterpart is a class,
each public method and class attribute.  Each one has
- the same name in the port module of the same path (port_module() gives
  the renamed modules), or
- an entry in MOVED: the port's "module:name" (one or more) that does its
  work under another name or in another module, or
- an entry in NO_COUNTERPART, whose name ROADMAP.md section A's list "No
  counterpart is planned for these" states with its reason.
Every function that reaches pl.pallas_call is one of the kernels that
chip_smoke.py builds, launches and records ("replaces"), or maps to one
of them in PALLAS_VIA.
"""

from __future__ import annotations

import ast
import functools
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "x264vfw_tpu"
PORT = "x264vfw_tpu_torch"

# JAX module -> port module, where the path differs (ops/pallas/* ->
# ops/kernels/* besides).
RENAMED = {
    "bitstream/cavlc_jax.py": "bitstream/cavlc_dev.py",
    "encode/tpu_encoder.py": "encode/torch_encoder.py",
    "decode/native_parse.py": "bitstream/native_parse.py",
}

# "JAX module:name" -> the port's "module:name"s that do its work.
MOVED = {
    "bitstream/cavlc_jax.py:ue_codes_j": ("bitstream/cavlc_dev.py:ue_codes_dev",),
    "bitstream/cavlc_jax.py:se_codes_j": ("bitstream/cavlc_dev.py:se_codes_dev",),
    # cavlc_jax's copies of the CAVLC tables as uint32/int32 arrays.
    "bitstream/cavlc_jax.py:CT_VAL": ("bitstream/cavlc_tables.py:COEFF_TOKEN_VAL",),
    "bitstream/cavlc_jax.py:CT_LEN": ("bitstream/cavlc_tables.py:COEFF_TOKEN_LEN",),
    "bitstream/cavlc_jax.py:TZ_VAL": ("bitstream/cavlc_tables.py:TOTAL_ZEROS_VAL",),
    "bitstream/cavlc_jax.py:TZ_LEN": ("bitstream/cavlc_tables.py:TOTAL_ZEROS_LEN",),
    "bitstream/cavlc_jax.py:TZC_VAL": (
        "bitstream/cavlc_tables.py:TOTAL_ZEROS_CDC_VAL",),
    "bitstream/cavlc_jax.py:TZC_LEN": (
        "bitstream/cavlc_tables.py:TOTAL_ZEROS_CDC_LEN",),
    "bitstream/cavlc_jax.py:RB_VAL": ("bitstream/cavlc_tables.py:RUN_BEFORE_VAL",),
    "bitstream/cavlc_jax.py:RB_LEN": ("bitstream/cavlc_tables.py:RUN_BEFORE_LEN",),
    # jax.jit wrappers of the cores, which the port calls eagerly.
    "encode/device.py:encode_i_frame": ("encode/device.py:encode_i_frame_core",),
    "encode/device.py:encode_p_frame": ("encode/device.py:encode_p_frame_core",),
    "encode/device.py:encode_b_frame": ("encode/device.py:encode_b_frame_core",),
    "encode/device_finalize.py:CBP_TO_CODE_J": ("bitstream/mb_syntax.py:CBP_TO_CODE",),
    "encode/device_finalize.py:encode_pgop_packed": (
        "encode/device_finalize.py:encode_pgop_slots",
        "encode/device_finalize.py:pack_batch"),
    "encode/inter_partition.py:partition_decide": (
        "encode/inter_partition.py:partition_decide_from_minima",),
    "encode/inter_partition.py:refine_deltas": ("ops/kernels/memc.py:refine_deltas",),
    "encode/tpu_encoder.py:TpuEncoder": ("encode/torch_encoder.py:TorchEncoder",),
    # The loop filter's numpy reference and XLA route: the kernel's plain
    # version, which applies the same maps.
    "ops/deblock.py:unpack_np": ("ops/kernels/deblock.py:_unpack",),
    "ops/deblock.py:apply_maps_np": ("ops/kernels/deblock.py:deblock_apply_plain",),
    "ops/deblock.py:deblock_apply_wavefront": (
        "ops/kernels/deblock.py:deblock_apply_plain",),
    # ops/transform's int32 copies of the transform tables.
    "ops/transform.py:DEQUANT_TABLE": ("ops/tables.py:DEQUANT_TABLE",),
    "ops/transform.py:QUANT_TABLE": ("ops/tables.py:QUANT_TABLE",),
    "ops/transform.py:QUANT_MF0": ("ops/tables.py:QUANT_MF",),
    "ops/transform.py:DEQUANT_V0": ("ops/tables.py:DEQUANT_V",),
    "ops/transform.py:ZIGZAG_4x4": ("ops/tables.py:ZIGZAG_4x4",),
    "ops/transform.py:CHROMA_QP_TABLE": ("ops/tables.py:_CHROMA_QP_TABLE",),
    "ops/transform.py:DEQUANT8_TABLE": ("ops/tables.py:DEQUANT8_TABLE",),
    "ops/transform.py:QUANT8_TABLE": ("ops/tables.py:QUANT8_TABLE",),
    "ops/transform.py:ZIGZAG_8x8": ("ops/tables.py:ZIGZAG_8x8",),
    "parallel/gop.py:tnp_chroma_qp": ("ops/tables.py:chroma_qp",),
}

# A JAX module, "module:name" or "module:Class.member" -> why the port has
# no counterpart.  The last component is named in ROADMAP.md's list.
_FALLBACK = ("says whether the C library loaded, for the fallback when it "
             "did not; the port's library builds or raises")
_UNREAD = "a module constant that no code reads"
NO_COUNTERPART = {
    "utils/cache.py": "the XLA compilation cache",
    "decode/device_recon.py": "only tests/test_device_recon.py calls it",
    "bitstream/cabac_native.py:available": _FALLBACK,
    "bitstream/cabac_transcode.py:available": _FALLBACK,
    "decode/native_parse.py:available": _FALLBACK,
    "decode/device_decode.py:decode_gop_core": (
        "the decoder's GOP batching, which amortises the TPU's dispatch"),
    "decode/device_decode.py:decode_gop_device": (
        "the decoder's GOP batching, which amortises the TPU's dispatch"),
    "encode/ref_encoder.py:RefEncoder": (
        "the JAX package's own numpy reference encoder"),
    "encode/tpu_encoder.py:TpuEncoder.PIPELINE_BUCKET": (
        "the TPU's speculative output bucket; the port sizes output exactly"),
    "encode/device_finalize.py:SBX": _UNREAD,
    "encode/device_finalize.py:SBY": _UNREAD,
    "encode/intra4x4.py:DEC_IDX": _UNREAD,
}

# A function that reaches pl.pallas_call -> the kernel function
# (chip_smoke.py's "replaces") that holds its work.
PALLAS_VIA = {
    "x264vfw_tpu/ops/pallas/sad.py:_sad_partition_minima_tiled":
        "x264vfw_tpu/ops/pallas/sad.py:sad_partition_minima",
}


def port_module(rel: str) -> str:
    if rel in RENAMED:
        return RENAMED[rel]
    if rel.startswith("ops/pallas/"):
        return "ops/kernels/" + rel[len("ops/pallas/"):]
    return rel


_MISSING = object()


def _tree(pkg: str, rel: str) -> ast.Module:
    with open(os.path.join(ROOT, pkg, rel)) as f:
        return ast.parse(f.read())


def _modules(pkg: str) -> list:
    base = os.path.join(ROOT, pkg)
    return sorted(os.path.relpath(os.path.join(d, n), base).replace(os.sep, "/")
                  for d, _, names in os.walk(base) for n in names
                  if n.endswith(".py"))


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        out = []
        for t in node.targets:
            out += [e for e in (t.elts if isinstance(t, ast.Tuple) else [t])
                    if isinstance(e, ast.Name)]
        return [e.id for e in out]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _bound(body, imports: bool) -> dict:
    """{name: node or None} bound by `body`'s statements (inside top-level
    if/try blocks too); imports too where `imports`."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.If, ast.Try)):
            blocks = [node.body, node.orelse]
            if isinstance(node, ast.Try):
                blocks += [node.finalbody] + [h.body for h in node.handlers]
            for b in blocks:
                out.update(_bound(b, imports))
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and imports:
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = None
        else:
            out.update(dict.fromkeys(_targets(node)))
    return out


def _members(cls: ast.ClassDef) -> dict:
    return _bound(cls.body, imports=False)


@functools.cache
def _port_names(rel: str) -> dict | None:
    """Names bound in the port module `rel`, or None if it does not exist."""
    if not os.path.exists(os.path.join(ROOT, PORT, rel)):
        return None
    return _bound(_tree(PORT, rel).body, imports=True)


def _resolve(target: str):
    """The ast node (True for an assignment or import) that the port's
    "module:name" or "module:Class.member" names, else None."""
    rel, name = target.split(":")
    head, _, member = name.partition(".")
    node = (_port_names(rel) or {}).get(head, _MISSING)
    if member:
        if not isinstance(node, ast.ClassDef):
            return None
        node = _members(node).get(member, _MISSING)
    return None if node is _MISSING else (node or True)


def _jax_names() -> list:
    """Every public name and class member of the JAX package, as
    "module:name" and "module:Class.member"."""
    out = []
    for rel in _modules(JAX):
        for name, node in sorted(_bound(_tree(JAX, rel).body, False).items()):
            if name.startswith("_"):
                continue
            out.append(f"{rel}:{name}")
            if isinstance(node, ast.ClassDef):
                out += [f"{rel}:{name}.{m}" for m in sorted(_members(node))
                        if not m.startswith("_")]
    return out


def _same_name(key: str) -> str:
    """The port name that `key` has where it keeps its name: in the port
    module of the same path, or for a member, in the class its class maps
    to."""
    rel, name = key.split(":")
    head, _, member = name.partition(".")
    if member and f"{rel}:{head}" in MOVED:
        return f"{MOVED[f'{rel}:{head}'][0]}.{member}"
    return f"{port_module(rel)}:{name}"


def _covered(key: str) -> bool:
    rel, name = key.split(":")
    head = name.partition(".")[0]
    if any(k in NO_COUNTERPART for k in (rel, f"{rel}:{head}", key)):
        return True
    return key in MOVED or _resolve(_same_name(key)) is not None


def test_every_jax_module_has_its_port_module():
    missing = [rel for rel in _modules(JAX)
               if _port_names(port_module(rel)) is None
               and rel not in NO_COUNTERPART]
    assert not missing, missing


def test_every_public_name_has_a_counterpart():
    keys = _jax_names()
    assert len(keys) > 500          # the walk found the package
    missing = [k for k in keys if not _covered(k)]
    assert not missing, missing


def test_every_mapped_port_name_exists():
    bad = [(k, t) for k, ts in MOVED.items() for t in ts
           if _resolve(t) is None]
    assert not bad, bad
    # A class maps to a class, whose members the first test compares.
    for k, ts in MOVED.items():
        jax_rel, name = k.split(":")
        node = _bound(_tree(JAX, jax_rel).body, False)[name]
        if isinstance(node, ast.ClassDef):
            assert isinstance(_resolve(ts[0]), ast.ClassDef), (k, ts[0])


def test_every_map_entry_is_needed():
    keys = set(_jax_names())
    modules = set(_modules(JAX))
    for k in [*MOVED, *NO_COUNTERPART]:
        if ":" not in k:
            assert k in modules and _port_names(port_module(k)) is None, k
            continue
        assert k in keys, f"{k} is not a public name of the JAX package"
        assert _resolve(_same_name(k)) is None, (
            f"{k}: the port has {_same_name(k)}, so the entry is not needed")


def test_every_no_counterpart_reason_is_in_the_roadmap():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    start = text.index("No counterpart is planned for these")
    section = text[start:text.index("\n\n", start)]
    for k, reason in NO_COUNTERPART.items():
        assert reason
        name = k.split(":")[-1].split(".")[-1] if ":" in k else k
        assert re.search(rf"(?<![\w/]){re.escape(name)}(?!\w)", section), (
            f"ROADMAP.md's no-counterpart list does not name {name}")


def _pallas_functions() -> dict:
    """{"x264vfw_tpu/<module>:<function>": def line} of each top-level
    function that contains a pl.pallas_call."""
    out = {}
    for rel in _modules(JAX):
        for node in _tree(JAX, rel).body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if any(isinstance(c, ast.Call)
                   and isinstance(c.func, ast.Attribute)
                   and c.func.attr == "pallas_call"
                   for c in ast.walk(node)):
                out[f"{JAX}/{rel}:{node.name}"] = node.lineno
    return out


def _chip_smoke_strings() -> list:
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def test_every_pallas_call_is_a_kernel_chip_smoke_records():
    funcs = _pallas_functions()
    assert len(funcs) == 5, sorted(funcs)
    by_line = {f"{k.split(':')[0]}:{line}": k for k, line in funcs.items()}
    replaces = {by_line.get(s, s) for s in _chip_smoke_strings()
                if re.fullmatch(rf"{JAX}/[\w/]+\.py:\d+", s)}
    # Each "replaces" of chip_smoke.py is the def line of such a function.
    assert replaces <= set(funcs), sorted(replaces - set(funcs))
    for f in funcs:
        assert f in replaces or PALLAS_VIA.get(f) in replaces, f
    # Each one's port wrapper exists, beside its plain PyTorch version.
    for f in replaces:
        rel, name = f[len(JAX) + 1:].split(":")
        for port_name in (name, name + "_plain"):
            assert _resolve(f"{port_module(rel)}:{port_name}") is not None, (
                f, port_name)
    sources = {s for s in _chip_smoke_strings()
               if re.fullmatch(r"csrc/\w+\.cu", s)}
    assert sources == {"csrc/sad.cu", "csrc/memc.cu", "csrc/deblock.cu"}
    for s in sources:
        assert os.path.exists(os.path.join(ROOT, PORT, s)), s
