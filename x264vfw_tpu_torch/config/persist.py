"""Config persistence — the registry-equivalent (JSON file instead of
HKCU\\Software\\GNU\\x264; reference config.c:93-145, 230-347).

Same semantics as the reference's declarative tables: load applies defaults
for missing keys and clamps out-of-range values; save writes the full
parameter set.  Default location: ~/.config/x264vfw_tpu_torch/config.json.
"""

from __future__ import annotations

import json
import os

from .params import EncoderParams

DEFAULT_PATH = os.path.expanduser("~/.config/x264vfw_tpu_torch/config.json")


def load(path: str | None = None) -> tuple[EncoderParams, list[str]]:
    """Load persisted params; missing file -> defaults (reg_load semantics)."""
    path = path or DEFAULT_PATH
    p = EncoderParams()
    if not os.path.exists(path):
        return p, []
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return p, [f"config load failed ({e}); using defaults"]
    p = EncoderParams.from_dict(data)
    warns = p.validate()
    return p, warns


def save(p: EncoderParams, path: str | None = None) -> None:
    path = path or DEFAULT_PATH
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(p.to_dict(), f, indent=2, sort_keys=True)
    os.replace(tmp, path)
