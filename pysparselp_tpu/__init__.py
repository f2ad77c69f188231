"""pysparselp_tpu — a sparse linear-programming framework in JAX.

Models and approximately solves large sparse LPs

    min cᵀx   s.t.   A_e x = b_e,   b_lower ≤ A_i x ≤ b_upper,   l ≤ x ≤ u

with the capabilities of martinResearch/PySparseLP, re-architected for an
accelerator (NVIDIA GPUs; the CPU for tests):
a host numpy modeling layer is lowered once into a statically-shaped,
device-resident problem on which JAX solvers run as compiled loops, sharded
over ``jax.sharding`` meshes for multi-device execution.
"""

from .batch import solve_cp_batch
from .checkpoint import (
    CheckpointingCallback,
    load_checkpoint,
    save_checkpoint,
)
from .modeling import SparseLP, solving_methods
from .sparse_host import BlockedCSR, crd_matrix

__all__ = [
    "SparseLP",
    "solving_methods",
    "BlockedCSR",
    "crd_matrix",
    "save_checkpoint",
    "load_checkpoint",
    "CheckpointingCallback",
    "solve_cp_batch",
]

__version__ = "0.1.0"
