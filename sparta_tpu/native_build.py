"""Build the native C++ helpers (sparta_tpu/csrc/) from committed sources on
the machine that runs them.

The library's file name carries a hash of the source, the compiler flags
and the host (``platform.uname()``), so a library built on one machine
(``-march=native`` code included) is never loaded on another: that machine
builds its own.  Builds land in ``csrc/_build/`` (listed in .gitignore) and
are written under a temporary name, then renamed, so concurrent processes
never load a half-written file.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"


def library_path(src: Path, name: str, flags: list[str]) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update("|".join(platform.uname()).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_native(src: Path, name: str, flags: list[str]) -> Path | None:
    """Path of the built library, building it first if needed; None when no
    toolchain is available (callers fall back to numpy)."""
    so = library_path(src, name, flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-shared", "-fPIC", str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so
