"""Config + CLI mirroring the reference's CLineReader (include/input.h:12-127).

Same single-letter flags, same defaults, so the reference's sweep-script flag
bundles (e.g. ``BCSR_reord = -F 1 -a 5 -M 6``) translate verbatim.  This
framework's own knobs get long-form flags.
"""
from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class Config:
    filename: str = "tests/fixtures/TEST_matrix_weighted.el"
    outfile: str = "results/TEST_results.txt"
    exp_name: str = ""
    reader_delimiter: str = " "
    mat_fmt: int = 0                # -R: 0 el, 1 mtx

    sim_use_groups: bool = False    # -g
    sim_use_pattern: bool = True    # -p
    pattern_only: bool = False      # -P 1 => ignore weights
    force_fixed_size: bool = False  # -F
    symmetrize: bool = False        # -e

    blocking_algo: int = 3          # -a
    seed: int = 123                 # -s (123 = engine default; -s 0 is honored)
    sim_measure: int = 1            # -m
    reorder: int = 0                # -r: -1 degree-asc, 1 degree-desc, 2 scramble
    col_block_size: int = 3         # -b
    row_block_size: int = 3         # -B
    tau: float = 0.1                # -t
    verbose: int = 1                # -v

    multiplication_algo: int = 0    # -M
    b_cols: int = 1024              # -c
    warmup: int = 1                 # -w
    exp_repetitions: int = 5        # -x
    n_streams: int = 4              # -S (schema compat; no stream knob here)

    # framework knobs
    dtype: str = "float32"          # --dtype {float32,bfloat16,int8}
    tile_n: int = 0                 # --tile-n (CSV schema only)
    inner_iters: int = 0            # --inner-iters (calls per timed window)
    backend: str = "auto"           # --backend {auto,native,numpy} for blocking
    csr_impl: str = "auto"          # --csr-impl {auto,fine,dedup,dedup256,fell,bcoo} for -M 2
    autotune: bool = False          # --autotune: measure kernel candidates
    save_grouping: bool = True


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sparta_tpu",
        description="Block-sparse SpMM experiments "
        "(flags mirror the reference CLI)",
    )
    d = Config()
    p.add_argument("-a", type=int, default=d.blocking_algo, dest="blocking_algo",
                   help="blocking algo 0..6 (default 3 iterative_clocked)")
    p.add_argument("-b", type=int, default=d.col_block_size, dest="col_block_size")
    p.add_argument("-B", type=int, default=d.row_block_size, dest="row_block_size")
    p.add_argument("-c", type=int, default=d.b_cols, dest="b_cols")
    p.add_argument("-e", type=int, default=0, dest="symmetrize")
    p.add_argument("-f", type=str, default=d.filename, dest="filename")
    p.add_argument("-F", type=int, default=0, dest="force_fixed_size")
    p.add_argument("-g", type=int, default=0, dest="sim_use_groups")
    p.add_argument("-m", type=int, default=d.sim_measure, dest="sim_measure")
    p.add_argument("-M", type=int, default=d.multiplication_algo,
                   dest="multiplication_algo")
    p.add_argument("-n", type=str, default="", dest="exp_name")
    p.add_argument("-o", type=str, default=d.outfile, dest="outfile")
    p.add_argument("-p", type=int, default=1, dest="sim_use_pattern")
    p.add_argument("-P", type=int, default=0, dest="pattern_only")
    p.add_argument("-r", type=int, default=d.reorder, dest="reorder")
    p.add_argument("-R", type=int, default=d.mat_fmt, dest="mat_fmt")
    p.add_argument("-s", type=int, default=d.seed, dest="seed")
    p.add_argument("-S", type=int, default=d.n_streams, dest="n_streams")
    p.add_argument("-t", type=float, default=d.tau, dest="tau")
    p.add_argument("-v", type=int, default=d.verbose, dest="verbose")
    p.add_argument("-w", type=int, default=d.warmup, dest="warmup")
    p.add_argument("-x", type=int, default=d.exp_repetitions, dest="exp_repetitions")
    p.add_argument("--dtype", type=str, default=d.dtype,
                   choices=["float32", "bfloat16", "int8", "fp8"])
    p.add_argument("--tile-n", type=int, default=d.tile_n, dest="tile_n")
    p.add_argument("--inner-iters", type=int, default=d.inner_iters, dest="inner_iters")
    p.add_argument("--backend", type=str, default=d.backend,
                   choices=["auto", "native", "numpy"])
    p.add_argument("--csr-impl", type=str, default=d.csr_impl,
                   dest="csr_impl",
                   choices=["auto", "fine", "dedup", "dedup256", "fell",
                            "bcoo"],
                   help="-M 2 path: auto (best unstructured execution) or "
                   "bcoo (scatter library baseline)")
    p.add_argument("--autotune", type=int, default=int(d.autotune),
                   dest="autotune",
                   help="measure the kernel candidates on-device and pick "
                   "the empirical winner (bench-quality selection)")
    p.add_argument("--save-grouping", type=int, default=int(d.save_grouping),
                   dest="save_grouping")
    return p


_FLAG_BY_FIELD = {
    "blocking_algo": "-a", "col_block_size": "-b", "row_block_size": "-B",
    "b_cols": "-c", "symmetrize": "-e", "filename": "-f",
    "force_fixed_size": "-F", "sim_use_groups": "-g", "sim_measure": "-m",
    "multiplication_algo": "-M", "exp_name": "-n", "outfile": "-o",
    "sim_use_pattern": "-p", "pattern_only": "-P", "reorder": "-r",
    "mat_fmt": "-R", "seed": "-s", "n_streams": "-S", "tau": "-t",
    "verbose": "-v", "warmup": "-w", "exp_repetitions": "-x",
    "dtype": "--dtype", "tile_n": "--tile-n", "inner_iters": "--inner-iters",
    "backend": "--backend", "csr_impl": "--csr-impl",
    "autotune": "--autotune", "save_grouping": "--save-grouping",
}

# fields intentionally without a CLI flag (defaults only)
_NO_FLAG_FIELDS = {"reader_delimiter"}


def config_to_argv(cfg: Config) -> list[str]:
    """Round-trip a Config into CLI argv (for subprocess-isolated sweeps)."""
    missing = ({f.name for f in dataclasses.fields(Config)}
               - set(_FLAG_BY_FIELD) - _NO_FLAG_FIELDS)
    assert not missing, f"Config fields without a CLI flag: {missing}"
    argv = []
    for field, flag in _FLAG_BY_FIELD.items():
        v = getattr(cfg, field)
        if isinstance(v, bool):
            v = int(v)
        argv += [flag, str(v)]
    return argv


def parse_args(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    cfg = Config()
    for f in dataclasses.fields(Config):
        if hasattr(ns, f.name):
            v = getattr(ns, f.name)
            if f.type == "bool":
                v = bool(v)
            setattr(cfg, f.name, v)
    return cfg


def main(argv=None):
    from .runtime import setup_compile_cache

    setup_compile_cache()
    from .bench.runner import run_experiment

    cfg = parse_args(argv)
    if cfg.verbose > 0:
        print("INPUT PARAMETERS:")
        for f in dataclasses.fields(cfg):
            print(f"  {f.name}: {getattr(cfg, f.name)}")
    result = run_experiment(cfg)
    if cfg.verbose > 0:
        for k, v in result.items():
            print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
