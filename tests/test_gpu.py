"""Checks that only mean something compiled on a GPU (skipped elsewhere;
``chip_smoke.py`` runs them on the card)."""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.mark.gpu
def test_compiled_dense_kernel_matches_xla(gpu_device):
    import chip_smoke

    chip_smoke.phase_dense_kernel(iters=200)


@pytest.mark.gpu
def test_dense_f32_matvec_is_not_tf32(gpu_device):
    from pysparselp_tpu.problem import DenseMatrix

    rng = np.random.RandomState(0)
    a = rng.randn(1024, 1024).astype(np.float32)
    v = rng.randn(1024).astype(np.float32)
    op = DenseMatrix(a=jnp.asarray(a), nrows=1024, ncols=1024)
    ref = a.astype(np.float64) @ v.astype(np.float64)
    got = np.asarray(op.matvec(jnp.asarray(v)), np.float64)
    assert np.max(np.abs(got - ref)) < 1e-5 * np.max(np.abs(ref))
