"""Composite column-block operator (problem.ColBlockMatrix) + the
column-split search in the lowering auto-selector.

The target shape is the ``[structured | ±I | …]`` matrices produced by
soft constraints / L1 penalizations / slack forms (e.g. the L1-SVM model,
``reference/pysparselp/examples/example_l1_svm.py:10-88``): no single
layout serves both the dense head and the diagonal tails."""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

import pysparselp_tpu.problem as pr


def _head_tail_matrix(m=4000, nd=300, ntail=4000, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(m, nd) * (rng.rand(m, nd) < 0.9)
    diag = scipy.sparse.diags([rng.rand(ntail) + 0.5], [0],
                              shape=(m, ntail))
    a = scipy.sparse.hstack(
        [scipy.sparse.csr_matrix(dense), diag]).tocsr()
    return a


def test_col_split_plan_finds_head_tail_boundary():
    a = _head_tail_matrix()
    name, whole = pr.estimate_stream_bytes(a, jnp.float32)
    cost, cuts = pr.col_split_plan(a, jnp.float32)
    assert cuts, "density-jump split not found"
    assert cost < 0.5 * whole, (cost, whole)
    # the refined candidate set finds the EXACT head|tail boundary at
    # column 300 (not a 128 multiple — see _candidate_cuts): the mixed
    # block a tile-aligned cut would create lowers far worse
    assert all(0 < c < a.shape[1] for c in cuts)
    assert 300 in cuts, cuts
    # uniform-density matrices produce no candidates (and pay no search)
    uni = scipy.sparse.random(2000, 2000, density=0.002, random_state=3,
                              format="csr")
    assert pr._candidate_cuts(uni) == []


def test_col_block_matrix_protocol_parity():
    a = _head_tail_matrix(seed=2)
    _, cuts = pr.col_split_plan(a, jnp.float32)
    op = pr._lower_col_split(a, cuts, jnp.float32, 4, 1.5)
    assert isinstance(op, pr.ColBlockMatrix)
    assert len(op.blocks) >= 2
    assert op.shape == a.shape
    rng = np.random.RandomState(5)
    x = rng.randn(a.shape[1]).astype(np.float32)
    y = rng.randn(a.shape[0]).astype(np.float32)
    np.testing.assert_allclose(op.matvec(jnp.asarray(x)), a @ x,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(op.rmatvec(jnp.asarray(y)), a.T @ y,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(op.abs_power_rowsum(1.0),
                               np.abs(a).sum(axis=1).A1,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(op.abs_power_colsum(1.0),
                               np.abs(a).sum(axis=0).A1,
                               rtol=1e-4, atol=1e-4)
    d = rng.rand(a.shape[1]).astype(np.float32)
    np.testing.assert_allclose(op.sq_rowsum_weighted(jnp.asarray(d)),
                               a.multiply(a) @ d, rtol=1e-4, atol=1e-4)
    assert op.nnz_padded == sum(b.nnz_padded for b in op.blocks)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a.toarray(),
                               rtol=1e-5, atol=1e-5)


def test_ell_from_scipy_prefer_split():
    a = _head_tail_matrix(seed=7)
    op = pr.ell_from_scipy(a, dtype=jnp.float32, prefer="split")
    assert isinstance(op, pr.ColBlockMatrix)


def test_auto_path_selects_split():
    """The auto-selector lowers head|tail matrices to composites (and the
    blocks themselves re-enter the selector: the dense head becomes a
    DenseMatrix)."""
    a = _head_tail_matrix(seed=9)
    op = pr.ell_from_scipy(a, dtype=jnp.float32)
    assert isinstance(op, pr.ColBlockMatrix)
    assert any(isinstance(b, pr.DenseMatrix) for b in op.blocks), (
        [type(b).__name__ for b in op.blocks])


def test_cp_solver_trajectory_invariant_under_split():
    """End-to-end: a soft-constraint LP solved with the composite operator
    matches the unsplit trajectory (the operator is exact, so curves
    coincide to float tolerance)."""
    import functools

    from pysparselp_tpu.solvers import chambolle_pock as cp_mod

    m, nd = 600, 140
    rng = np.random.RandomState(11)
    a = _head_tail_matrix(m=m, nd=nd, ntail=m, seed=11)
    n = a.shape[1]
    c = rng.rand(n)
    lb, ub = np.zeros(n), np.ones(n)
    b_up = a @ (rng.rand(n) * 0.5) + 0.1
    kwargs = dict(nb_max_iter=60, nb_iter_plot=30, dtype=jnp.float32,
                  permute=False)
    x_ref, _ = cp_mod.chambolle_pock_ppd(
        c, None, None, a, None, b_up, lb, ub, **kwargs)
    orig = pr.ell_from_scipy
    try:
        cp_mod.ell_from_scipy = functools.partial(orig, prefer="split")
        x_split, _ = cp_mod.chambolle_pock_ppd(
            c, None, None, a, None, b_up, lb, ub, **kwargs)
    finally:
        cp_mod.ell_from_scipy = orig
    np.testing.assert_allclose(x_split, x_ref, rtol=2e-4, atol=2e-4)


def test_split_operator_in_other_solvers(monkeypatch):
    """Solvers that consume the generic operator protocol (mehrotra uses
    sq_rowsum_weighted) accept the composite backend."""
    import functools

    from pysparselp_tpu.solvers import mehrotra as mod

    rng = np.random.RandomState(3)
    m, nd = 40, 20
    dense = rng.rand(m, nd) + 0.1
    a = scipy.sparse.hstack(
        [scipy.sparse.csr_matrix(dense),
         scipy.sparse.eye(m)]).tocsr()
    xf = rng.rand(a.shape[1]) + 0.5
    b = a @ xf
    c = rng.rand(a.shape[1]) + 0.1
    # dense_threshold=0 keeps the matrix-free (operator-protocol) CG path
    ref_f, _x_ref, *_ = mod.mpc_sol(a, b, c, max_iter=30,
                                    dense_threshold=0)
    monkeypatch.setattr(mod, "ell_from_scipy",
                        functools.partial(pr.ell_from_scipy,
                                          prefer="split"))
    f, _x, *_ = mod.mpc_sol(a, b, c, max_iter=30, dense_threshold=0)
    np.testing.assert_allclose(f, ref_f, rtol=1e-6, atol=1e-8)
