"""Bench workload builders are driver-critical: they must be
deterministic (the recorded reference-CPU baselines were measured on
these exact matrices) and must match the shapes recorded in bench.py's
baseline provenance comments."""

import sys

import numpy as np

sys.path.insert(0, ".")

import bench  # noqa: E402


def test_unstructured_matrix_matches_baseline_provenance():
    a, b, c = bench._unstructured_matrix()
    assert a.shape == (150_000, 100_000)
    assert a.nnz == 1_949_874  # the matrix the 126.8 it/s ref ran on
    # feasible interior point => the LP is feasible by construction
    assert b.shape == (150_000,) and c.shape == (100_000,)
    a2, b2, _ = bench._unstructured_matrix()
    assert a2.nnz == a.nnz and np.array_equal(b2, b)


def test_kmedians_lp_matches_baseline_provenance():
    lp = bench._kmedians_lp()
    assert lp.nb_variables == 150_030
    assert lp.a_inequalities.shape[0] == 150_001
    assert lp.a_equalities.shape == (5_000, 150_030)
    assert lp.a_inequalities.nnz + lp.a_equalities.nnz == 450_030


def test_transport_lp_matches_baseline_provenance():
    lp = bench._transport_lp()
    ae = lp.a_equalities
    # the matrix the 30.5 it/s reference baseline ran on (2 nnz/arc)
    assert ae.shape == (100_000, 1_000_000)
    assert ae.nnz == 2_000_000
    # one never-binding ineq row keeps the reference's metrics block
    # (which crashes on eq-only systems) alive — see _transport_lp
    assert lp.a_inequalities.shape[0] == 1
    assert lp.a_inequalities.nnz == 2
    lp2 = bench._transport_lp()
    assert np.array_equal(lp2.b_equalities, lp.b_equalities)
    assert np.array_equal(lp2.costsvector, lp.costsvector)
    # supplies/demands from a feasible flow: total supply == total demand
    n_src = 50_000
    assert np.isclose(lp.b_equalities[:n_src].sum(),
                      lp.b_equalities[n_src:].sum())


def test_banded_lp_is_deterministic_and_xla_dia_eligible():
    from pysparselp_tpu.batch import _lower_xla
    from pysparselp_tpu.problem import DiaMatrix
    import jax.numpy as jnp

    lp = bench._banded_lp(n=4_096)
    a = lp.a_inequalities.tocsr()
    assert a.shape == (4_096, 4_096)
    lp2 = bench._banded_lp(n=4_096)
    assert np.array_equal(lp2.b_upper, lp.b_upper)
    # the full-size system routes to the shift-loop DIA operator (the
    # 4k test build is below the dense threshold, so check the operator
    # directly rather than the auto route)
    op = DiaMatrix.from_scipy(a, jnp.float64)
    x = np.random.RandomState(1).rand(a.shape[1])
    assert np.allclose(np.asarray(op.matvec(x)), a @ x)
    assert len(op.offsets) == 4
    # at bench scale the auto route picks DiaMatrix: entries exceed
    # the dense cap and the offset count is 4
    from pysparselp_tpu.problem import DENSE_AUTO_MAX_ENTRIES
    assert 150_000 ** 2 > DENSE_AUTO_MAX_ENTRIES
    del _lower_xla
