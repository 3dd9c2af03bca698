"""Provenance-stamped result JSON writer shared by every bench script.

Round-3 lesson: ``--quick`` CPU smoke runs silently overwrote canonical
hardware artifacts (results/knobs_probe.json at 0.02 TF/s), and nothing in
the JSON said which backend produced it.  Every result writer now stamps
``_provenance`` (backend, devices, quick flag, argv, timestamp) and a quick
run is PHYSICALLY unable to claim the canonical path — it is rerouted to
``<stem>_quick.json``.

Reference analog: the reference's CSVs are all device-measured
(``/root/reference/rmtas_multiplication.csv``); there is no ambiguity to
guard against there — here a CPU run makes one.
"""
from __future__ import annotations

import datetime
import json
import sys
from pathlib import Path
from typing import Any


def provenance(quick: bool = False) -> dict[str, Any]:
    """Backend/devices/argv stamp. Safe to call before/without jax init."""
    stamp: dict[str, Any] = {
        "quick": bool(quick),
        "argv": sys.argv[1:],
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
    }
    try:
        import jax

        stamp["backend"] = jax.default_backend()
        stamp["devices"] = [str(d) for d in jax.devices()]
    except Exception as e:  # noqa: BLE001 — stamp the failure, don't raise
        stamp["backend"] = f"unavailable: {e}"
        stamp["devices"] = []
    return stamp


def quick_path(path: str | Path) -> Path:
    p = Path(path)
    return p.with_name(p.stem + "_quick" + p.suffix)


def write_result(path: str | Path, payload: Any, *,
                 quick: bool = False, hw_only: bool = False) -> Path:
    """Write ``payload`` as JSON with a ``_provenance`` stamp.

    ``quick=True`` reroutes to ``<stem>_quick.json`` so a smoke run can
    never clobber a canonical hardware artifact.  ``hw_only=True``
    additionally reroutes a full (non-quick) run on a CPU backend to
    ``<stem>_cpu.json`` — for scripts whose canonical artifact is a
    hardware measurement.  Returns the path actually written.  Non-dict
    payloads are wrapped as ``{"data": ..., "_provenance": ...}``.
    """
    p = Path(path)
    stamp = provenance(quick=quick)
    if quick:
        p = quick_path(p)
    elif hw_only and stamp.get("backend") == "cpu":
        p = p.with_name(p.stem + "_cpu" + p.suffix)
    if isinstance(payload, dict):
        doc = dict(payload)
        doc["_provenance"] = stamp
    else:
        doc = {"data": payload, "_provenance": stamp}
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=1))
    return p
