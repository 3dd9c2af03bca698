"""Core enums, type aliases and constants for sparta_tpu.

A re-design of the reference framework's primitive layer
(reference: include/definitions.h). Numeric codes of the enums are kept
compatible with the reference CLI so sweep configs translate 1:1.
"""
from __future__ import annotations

import enum

import numpy as np

# Index / value dtypes.
# The reference uses intT = long and DataT = float (include/definitions.h:8-9).
# Here indices are int32 (sufficient for < 2^31 nnz) and values float32
# host-side, with bfloat16 storage on the device paths.
INT = np.int32
DATA = np.float32

class MatrixFormat(enum.IntEnum):
    """Input file formats (reference include/definitions.h:15)."""

    el = 0   # space-separated edge list, 0-based, optional weight column
    mtx = 1  # MatrixMarket


class BlockingType(enum.IntEnum):
    """Row-blocking / reordering algorithms (reference include/definitions.h:17).

    Numeric codes match the reference ``-a`` flag.
    """

    iterative = 0             # greedy seed-and-sweep (blocking.cpp:89-154)
    iterative_structured = 1  # + m:n structured-sparsity gate (blocking.cpp:20-87)
    fixed_size = 2            # natural blocking: grouping[i] = i // row_block_size
    iterative_clocked = 3     # default: algo 0 + distance-cache pruning (blocking.cpp:156-243)
    iterative_queue = 4       # queue variant (blocking.cpp:245-338)
    iterative_max_size = 5    # capped block height + keeper top-up (blocking.cpp:433-549)
    scramble = 6              # random permutation baseline (blocking.cpp:565-574)
    hash_greedy = 7           # NEW: signature dedup + greedy over uniques (ours)


class SimMeasure(enum.IntEnum):
    """Row-distance functions (reference ``-m`` flag, blocking.cpp:699-717).

    The *_alt variants correspond to the reference's "...OPENMP" functions,
    which (despite the name) are alternate serial implementations with a
    different group-size weighting (count_zeros=0 vs 1).
    """

    hamming = 0
    jaccard = 1
    hamming_alt = 2
    jaccard_alt = 3


class MultiplicationAlgo(enum.IntEnum):
    """SpMM backends (reference include/definitions.h:19, ``-M`` flag).

    The reference codes map onto this framework's backends as follows:

    ===== ============================== ===========================================
    code  reference backend              sparta_tpu backend
    ===== ============================== ===========================================
    0     NO_MULT                        no multiplication (blocking-only run)
    1     cublas_gemm (dense)            XLA dense matmul (jnp.dot, densified A)
    2     cusparse_spmm (CSR)            CSR SpMM baseline (BCOO / segment-sum)
    3     cusparse_bellpack              Blocked-ELL SpMM, pure-XLA gather+einsum
    4     cublas_vbr (fixed, C=A.B)      VBR SpMM, height-bucketed XLA
    5     cublas_vbr_fixed               (alias of 4; dead code in the reference)
    6     cublas_vbr_inverted (C=B.A)    VBR SpMM inverted operand order
    7     cublas_vbr_batched             VBR SpMM, per-diagonal batched XLA
    8     cutlass_bellpack               Blocked-ELL SpMM, plan_spmm (Triton kernel)
    9     cutlass_gemm (dense)           dense matmul (as 1: cuBLAS via XLA)
    10    cutlas_vbr                     VBR SpMM, blocked kernel (bucketed)
    11    cutlas_vbr_inverted            VBR SpMM inverted, blocked kernel
    12    cutlas_vbr_batched             Blocked-ELL SpMM, plan_spmm (as 8)
    ===== ============================== ===========================================
    """

    no_mult = 0
    dense_xla = 1
    csr_spmm = 2
    bell_xla = 3
    vbr_xla = 4
    vbr_xla_fixed = 5
    vbr_xla_inverted = 6
    vbr_xla_batched = 7
    bell_pallas = 8
    dense_pallas = 9
    vbr_pallas = 10
    vbr_pallas_inverted = 11
    bell_pallas_batched = 12


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ceil_div(x, m) * m


def to_device(arr, dtype=None):
    """Upload a host array and cast ON DEVICE.  numpy's elementwise cast
    to ml_dtypes types (bfloat16/fp8) runs ~90 ns/elem and dominates
    ingest for large operands; XLA's convert is ~free."""
    import jax.numpy as jnp

    x = jnp.asarray(arr)
    return x if dtype is None else x.astype(dtype)
