"""Process set-up shared by the entry points (bench.py, chip_smoke.py, the
CLI and scripts/): the persistent compile cache and the device report.

Nothing here initializes a JAX backend except :func:`device_info`, and
``card_info`` reads ``nvidia-smi`` from a child process that never imports
JAX, so one process keeps the card to itself.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def setup_compile_cache() -> str:
    """Use JAX's persistent compilation cache.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache lives at the fixed ``<repo>/.jax_cache``
    (listed in .gitignore): the path is part of the cache key, so a
    directory that moved would never hit.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def card_info() -> str:
    """``name, power.limit`` of the NVIDIA cards, as nvidia-smi prints them
    ("" when there is no nvidia-smi, as on a CPU host)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip() if r.returncode == 0 else ""


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it, plus the
    card's name and power limit."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def require_gpu() -> None:
    """A measurement path that finds no GPU fails; it never falls back."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {platform!r}; "
                         "device measurements run only on the card")
