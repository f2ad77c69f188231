"""Tests for the device lowering (EllMatrix SpMV correctness)."""

import numpy as np
import pytest
import scipy.sparse

from pysparselp_tpu.problem import EllMatrix, lower_lp
from pysparselp_tpu.utils.random_lp import generate_random_lp


def test_ell_matvec_matches_scipy():
    rng = np.random.RandomState(0)
    a = scipy.sparse.random(37, 53, density=0.1, random_state=rng, format="csr")
    m = EllMatrix.from_scipy(a)
    x = rng.randn(53)
    y = rng.randn(37)
    np.testing.assert_allclose(np.asarray(m.matvec(x)), a @ x, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(m.rmatvec(y)), a.T @ y, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(m.to_dense()), a.toarray(), rtol=1e-12)


def test_ell_empty_rows_and_cols():
    a = scipy.sparse.csr_matrix((5, 7))
    a[2, 3] = 4.0
    m = EllMatrix.from_scipy(a.tocsr())
    x = np.arange(7, dtype=float)
    np.testing.assert_allclose(np.asarray(m.matvec(x)), a @ x)
    np.testing.assert_allclose(np.asarray(m.rmatvec(np.ones(5))), a.T @ np.ones(5))


def test_lower_lp_roundtrip():
    lp, x_feas = generate_random_lp(nbvar=25, n_eq=5, n_ineq=20, sparsity=0.3, seed=4)
    prob = lower_lp(lp)
    assert prob.n == 25
    x = np.asarray(x_feas)
    r_eq = np.asarray(prob.a_eq.matvec(x)) - np.asarray(prob.b_eq)
    np.testing.assert_allclose(r_eq, 0.0, atol=1e-9)
    r = np.asarray(prob.a_ineq.matvec(x))
    assert np.all(r <= np.asarray(prob.b_upper) + 1e-9)


def test_backend_cost_model_selection(monkeypatch):
    """Auto-selection picks by bytes-streamed cost, on every backend."""
    import scipy.sparse

    import pysparselp_tpu.problem as pm
    from pysparselp_tpu.ops.bsr import BsrMatrix, bsr_padded_entries

    # tiny dense-friendly matrix -> dense
    rng = np.random.RandomState(0)
    a = scipy.sparse.csr_matrix(rng.rand(40, 30))
    assert isinstance(pm.ell_from_scipy(a), pm.DenseMatrix)

    # few-diagonal banded system, too large to densify -> DIA
    n = 3000
    diags = [np.ones(n), 2 * np.ones(n - 1)]
    band = scipy.sparse.diags(diags, [0, 1], shape=(n, n)).tocsr()
    monkeypatch.setattr(pm, "DENSE_AUTO_MAX_ENTRIES", 1000)
    assert isinstance(pm.ell_from_scipy(band), pm.DiaMatrix)

    # many-staircase-diagonal structured matrix (Potts-like): gathers of a
    # local pattern are cheap, so gather-ELL beats 128x128 tiles and every
    # column split of the staircase bands
    rows = np.arange(20000).repeat(3)
    cols_ = np.stack([rows[::3], rows[::3] // 7 + 9000,
                      rows[::3] // 3 + 14000], 1).ravel()
    m2 = scipy.sparse.coo_matrix(
        (np.ones(rows.size), (rows, np.clip(cols_, 0, 19999))),
        shape=(20000, 20000)).tocsr()
    whole, whole_cost = pm.estimate_stream_bytes(m2, None)
    assert whole == "ell", (whole, whole_cost)
    assert whole_cost < bsr_padded_entries(m2) * 8
    assert isinstance(pm.ell_from_scipy(m2, prefer="bsr"), BsrMatrix)
    split_cost, cuts = pm.col_split_plan(m2, None)
    assert not cuts and split_cost == whole_cost
    sel = pm.ell_from_scipy(m2)
    assert isinstance(sel, (pm.EllMatrix, pm.SegmentedEllMatrix)), (
        type(sel).__name__)


def test_rcm_permutation_is_a_permutation():
    import scipy.sparse

    from pysparselp_tpu.problem import rcm_permutation

    a = scipy.sparse.random(60, 45, density=0.1,
                            random_state=np.random.RandomState(0),
                            format="csr")
    rows, cols = rcm_permutation(a)
    assert sorted(rows) == list(range(60))
    assert sorted(cols) == list(range(45))
    # permuted matrix holds the same entries
    a2 = a[rows, :][:, cols]
    assert a2.nnz == a.nnz
    np.testing.assert_allclose(np.sort(a2.data), np.sort(a.data))


def test_rcm_reduces_potts_padding():
    from pysparselp_tpu.examples.potts import build_linear_program
    from pysparselp_tpu.ops.bsr import bsr_padded_entries
    from pysparselp_tpu.problem import rcm_permutation
    from pysparselp_tpu.solvers.chambolle_pock import _fold_one_sided

    lp, _, _, _ = build_linear_program(30, 0.5, 500)
    a, _ = _fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper)
    rows, cols = rcm_permutation(a)
    assert bsr_padded_entries(a[rows, :][:, cols]) < 0.7 * bsr_padded_entries(a)


@pytest.mark.parametrize("prefer", ["ell", "dia", "dense", "bsr",
                                    "segmented"])
def test_abs_power_zero_counts_stored_entries_only(prefer):
    """alpha in {0, 2} sends p=0 through abs_power_*: padded layout slots
    must not count (0**0 == 0 in every backend), matching the reference's
    scipy .power(p) over stored CSR entries (ChambollePockPPD.py:158-179)."""
    import jax.numpy as jnp

    from pysparselp_tpu import problem as pm

    rng = np.random.RandomState(12)
    a = scipy.sparse.random(60, 45, density=0.08, random_state=rng,
                            format="csr")
    a.data[:] = rng.randn(a.nnz)
    a.eliminate_zeros()
    op = pm.ell_from_scipy(a, dtype=jnp.float32, prefer=prefer)
    row_nnz = np.diff(a.indptr).astype(np.float32)
    col_nnz = np.diff(a.tocsc().indptr).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.abs_power_rowsum(0.0)),
                               row_nnz, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(op.abs_power_colsum(0.0)),
                               col_nnz, rtol=1e-6, atol=1e-6)
