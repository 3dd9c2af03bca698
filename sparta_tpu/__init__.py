"""sparta_tpu — block-sparse linear algebra in JAX, on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference SPARTA pipeline: similarity-based row reordering that densifies
unstructured sparse matrices into blocked formats (VBR / Blocked-ELL),
followed by blocked SpMM on the tensor cores, with CSR/dense baselines, quality
metrics, a benchmark harness, and multi-chip scaling via jax.sharding.
"""

__version__ = "0.1.0"

from .definitions import (
    BlockingType,
    MatrixFormat,
    MultiplicationAlgo,
    SimMeasure,
)

__all__ = [
    "BlockingType",
    "MatrixFormat",
    "MultiplicationAlgo",
    "SimMeasure",
    "__version__",
]
