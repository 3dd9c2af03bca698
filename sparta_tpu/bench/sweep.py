"""Experiment sweeps with idempotent resume.

The counterpart of the reference's SLURM sweep layer
(src/scripts/run_blocking_experiments*.sh, run_multiplication_experiments_
fixed_cluster.sh): a sweep is a grid over {matrix, tau, block sizes, algo,
backend}; each cell runs as one experiment whose output file is keyed by a
config hash — existing outputs are skipped, so an interrupted sweep resumes
for free (the reference's skip-if-output-exists pattern,
run_blocking_experiments_cluster.sh:59-65).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from pathlib import Path

from ..cli import Config
from .runner import run_experiment

# named flag bundles from the reference sweep scripts
# (run_multiplication_experiments_fixed_cluster.sh:14-20)
EXPERIMENT_BUNDLES = {
    "BCSR_reord": dict(force_fixed_size=True, blocking_algo=5, multiplication_algo=6),
    "BCSR_no_reord": dict(force_fixed_size=True, blocking_algo=2, multiplication_algo=6),
    "CSR": dict(multiplication_algo=2),
    "GEMM": dict(multiplication_algo=1),
    "BELLPACK_no_block": dict(force_fixed_size=True, blocking_algo=2,
                              multiplication_algo=3),
    "BELLPACK_blocked": dict(force_fixed_size=True, blocking_algo=5,
                             multiplication_algo=3),
    "PALLAS_blocked": dict(force_fixed_size=True, blocking_algo=5,
                           multiplication_algo=8),
    "PALLAS_int8": dict(force_fixed_size=True, blocking_algo=5,
                        multiplication_algo=8, dtype="int8"),
}


def config_hash(cfg: Config) -> str:
    """Stable cell key: hash only fields that differ from the Config default,
    so adding new defaults-only fields to Config keeps cell hashes (and
    cached sweep results) valid GOING FORWARD.  Cells written under an older
    hash scheme are not invalidated either: run_sweep adopts any cached cell
    whose row CONTENT matches the config (renaming it to the current hash),
    so a scheme change never re-runs cells or duplicates rows in
    collect_csvs."""
    payload = {}
    for f in dataclasses.fields(cfg):
        if f.name in ("outfile", "verbose"):
            continue
        v = getattr(cfg, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        payload[f.name] = v
    return hashlib.sha1(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _extract_error_line(stderr: str) -> str:
    """Surface the actual exception line from a failed cell's stderr — not
    JAX's traceback-filter notice, which is the literal last line on any
    jax error."""
    lines = (stderr or "").strip().splitlines() or ["?"]
    return next(
        (ln for ln in reversed(lines)
         if ("Error" in ln or "Exception" in ln)
         and "JAX_TRACEBACK_FILTERING" not in ln),
        " | ".join(lines[-3:]),
    )


def _run_cell_isolated(cfg: Config, timeout: int = 1800) -> dict:
    """Run one experiment in a fresh subprocess.

    A kernel fault can leave a process's device client unusable, so each
    cell gets a fresh process.  The parent never initializes JAX, so the
    child has the card to itself.  A failed cell raises; it is not
    retried."""
    import subprocess
    import sys

    from ..cli import config_to_argv

    argv = config_to_argv(dataclasses.replace(cfg, verbose=0))
    try:
        r = subprocess.run(
            [sys.executable, "-m", "sparta_tpu.cli", *argv],
            capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"cell timed out after {timeout}s") from None
    result_json = Path(str(cfg.outfile) + ".json")
    if r.returncode == 0 and result_json.exists():
        return json.loads(result_json.read_text())
    raise RuntimeError(f"cell failed: {_extract_error_line(r.stderr)[:300]}")


# Config field -> result-row field pairs that uniquely identify a sweep
# cell's configuration inside one matrix stem (used to adopt cells cached
# under an older config_hash scheme instead of re-running them)
_CELL_IDENTITY = (
    ("exp_name", "exp_name"), ("b_cols", "b_cols"), ("tau", "tau"),
    ("row_block_size", "row_block_size"),
    ("col_block_size", "col_block_size"),
    ("multiplication_algo", "multiplication_algo"),
    ("blocking_algo", "blocking_algo"), ("sim_measure", "sim_measure"),
    ("sim_use_groups", "sim_use_groups"), ("sim_use_pattern", "use_pattern"),
    ("reorder", "reorder"), ("symmetrize", "symmetrize"),
    ("n_streams", "n_streams"), ("warmup", "warmup"),
    ("exp_repetitions", "exp_repetitions"),
)

# Knobs added after the original row schema.  A legacy row (written before
# the knob existed in rows) can only have been produced by the knob's
# DEFAULT value, so: row has the field -> exact match required; row lacks
# it -> adopt only when cfg holds the default.  Without this, a grid over
# e.g. csr_impl=[fine,dedup] could adopt (rename) a sibling cell that
# differs only in csr_impl and silently record one impl's results under
# the other's hash.
_LATE_IDENTITY = ("dtype", "csr_impl", "tile_n", "inner_iters", "autotune")
_CFG_DEFAULTS = {f.name: f.default for f in dataclasses.fields(Config)}


def _value_matches(want, got) -> bool:
    if isinstance(want, float):
        return abs(float(got) - want) <= 1e-12
    if isinstance(want, str):
        return str(got) == want
    return int(got) == int(want)


def _row_matches(row: dict, cfg: Config) -> bool:
    for cf, rf in _CELL_IDENTITY:
        if rf not in row:
            return False
        if not _value_matches(getattr(cfg, cf), row[rf]):
            return False
    for cf in _LATE_IDENTITY:
        want = getattr(cfg, cf)
        if cf in row:
            if not _value_matches(want, row[cf]):
                return False
        elif want != _CFG_DEFAULTS[cf]:
            return False
    return True


def _adopt_legacy_cell(cell: Path, cfg: Config, stem: str) -> None:
    """Resume across config_hash scheme changes: if this config's result is
    cached under a DIFFERENT (legacy) hash, rename it — and its .csv /
    .csv.json / .csv.g siblings — to the current cell name, so the sweep
    neither re-runs the cell nor leaves a duplicate row for collect_csvs."""
    if cell.exists():
        return
    for old in sorted(cell.parent.glob(f"{stem}_*.json")):
        if old == cell or old.name.endswith(".csv.json"):
            continue
        try:
            row = json.loads(old.read_text())
        except (json.JSONDecodeError, OSError):
            continue
        if not isinstance(row, dict) or not _row_matches(row, cfg):
            continue
        oldbase, newbase = old.with_suffix(""), cell.with_suffix("")
        for ext in (".json", ".csv", ".csv.json", ".csv.g"):
            src = Path(str(oldbase) + ext)
            if src.exists() and not Path(str(newbase) + ext).exists():
                src.rename(str(newbase) + ext)
        return


def run_sweep(
    matrices: list[str],
    grid: dict,
    out_dir: str | Path,
    base: Config | None = None,
    resume: bool = True,
    on_result=None,
    isolate: bool = False,
) -> list[dict]:
    """grid: {field_name: [values...]}.  Returns result rows (loaded from
    disk for skipped cells).  ``isolate`` runs each cell in its own
    subprocess (see _run_cell_isolated)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    keys = list(grid)
    for matrix in matrices:
        for combo in itertools.product(*(grid[k] for k in keys)):
            cfg = dataclasses.replace(base or Config())
            cfg.filename = str(matrix)
            for k, v in zip(keys, combo):
                setattr(cfg, k, v)
            h = config_hash(cfg)
            stem = Path(str(matrix)).stem
            cell = out_dir / f"{stem}_{h}.json"
            cfg.outfile = str(out_dir / f"{stem}_{h}.csv")
            if resume:
                _adopt_legacy_cell(cell, cfg, stem)
            if resume and cell.exists():
                results.append(json.loads(cell.read_text()))
                continue
            if isolate:
                row = _run_cell_isolated(cfg)
            else:
                row = run_experiment(cfg)
            row = {k: (v if not hasattr(v, "item") else v.item())
                   for k, v in row.items()}
            cell.write_text(json.dumps(row, default=float))
            results.append(row)
            if on_result:
                on_result(row)
    return results


def collect_csvs(out_dir: str | Path, dest: str | Path) -> int:
    """Concatenate per-run 2-line CSVs into one table (reference
    collect_experiments.sh / utils/collect_*.sh).

    Cells written by different framework versions can carry different
    EXTRA column tails; rows are merged BY NAME (first file's order,
    new fields appended; missing values empty) so schemas never
    misalign silently."""
    import csv as csvmod

    out_dir = Path(out_dir)
    rows: list[dict] = []
    fields: list[str] = []
    for f in sorted(out_dir.glob("*.csv")):
        lines = f.read_text().strip().splitlines()
        if len(lines) < 2:
            continue
        for r in csvmod.DictReader(lines):
            rows.append(r)
            for k in r:
                if k not in fields:
                    fields.append(k)
    if not fields:
        return 0
    with open(dest, "w", newline="") as fh:
        w = csvmod.DictWriter(fh, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)
    return len(rows)
