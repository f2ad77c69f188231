"""Batched serving API (`pysparselp_tpu.batch.solve_cp_batch`): one
constraint matrix, many cost/rhs/bound variants, one vmapped CP loop."""

import numpy as np
import pytest

import jax

import jax.numpy as jnp

from pysparselp_tpu import SparseLP
from pysparselp_tpu.batch import _lower_xla, solve_cp_batch
from pysparselp_tpu.problem import DenseMatrix, EllMatrix
from pysparselp_tpu.utils.random_lp import generate_random_lp


def _template(seed=11):
    lp, _ = generate_random_lp(nbvar=24, n_eq=4, n_ineq=18, sparsity=0.3,
                               seed=seed)
    return lp


def test_batch_matches_single_problem_trajectory():
    """Each batch element's iterates equal the single-problem per-op CP
    chunk run on the same operators/preconditioners (exact vmap parity)."""
    from pysparselp_tpu.batch import _batched_chunk  # noqa: F401
    from pysparselp_tpu.solvers.chambolle_pock import cp_chunk_impl

    lp = _template()
    rng = np.random.RandomState(0)
    B = 3
    C = lp.costsvector[None, :] * (1.0 + 0.3 * rng.rand(B, lp.nb_variables))
    X, info = solve_cp_batch(lp, costs=C, nb_iter=40, nb_iter_plot=40,
                             dtype=np.float64)

    # rebuild the identical unbatched problem per element and re-run
    import scipy.sparse

    from pysparselp_tpu.problem import LPProblem
    from pysparselp_tpu.solvers.chambolle_pock import _fold_one_sided

    a_one, b_one = _fold_one_sided(lp.a_inequalities.tocsr(),
                                   lp.b_lower, lp.b_upper)
    a_eq = lp.a_equalities.tocsr()
    eq_m = _lower_xla(a_eq, jnp.float64)
    in_m = _lower_xla(a_one, jnp.float64)
    n = lp.nb_variables
    col_sum = np.zeros(n)
    pre = {"theta": jnp.asarray(1.0, jnp.float64)}
    for key, a in (("sigma_eq", a_eq), ("sigma_ineq", a_one)):
        aa = scipy.sparse.csr_matrix(a).copy()
        aa.data = np.abs(aa.data)
        col_sum += np.asarray(aa.sum(axis=0)).ravel()
        rs = np.asarray(aa.sum(axis=1)).ravel()
        rs[rs == 0] = 1.0
        pre[key] = jnp.asarray(1.0 / rs, jnp.float64)
    col_sum[col_sum == 0] = 1.0
    pre["diag_t"] = jnp.asarray(1.0 / col_sum, jnp.float64)

    for b in range(B):
        prob = LPProblem(
            c=jnp.asarray(C[b]), lb=jnp.asarray(lp.lower_bounds * 1.0),
            ub=jnp.asarray(lp.upper_bounds * 1.0),
            a_eq=eq_m, b_eq=jnp.asarray(lp.b_equalities * 1.0),
            a_ineq=in_m, b_lower=None, b_upper=jnp.asarray(b_one),
            n=n, m_eq=eq_m.nrows, m_ineq=in_m.nrows)
        st = (jnp.zeros(n), jnp.zeros(n), jnp.zeros(eq_m.nrows),
              jnp.zeros(in_m.nrows))
        st, metrics = cp_chunk_impl(prob, pre, st, 40)
        np.testing.assert_allclose(X[b], np.asarray(st[0]), atol=1e-12)
        np.testing.assert_allclose(info["energy1"][-1][b],
                                   float(metrics["energy1"]), atol=1e-12)


def test_batch_costs_converge_to_ground_truth():
    lp = _template(seed=7)
    rng = np.random.RandomState(1)
    B = 4
    C = lp.costsvector[None, :] + 0.2 * rng.randn(B, lp.nb_variables)
    X, info = solve_cp_batch(lp, costs=C, nb_iter=30000, nb_iter_plot=30000,
                             dtype=np.float64)
    assert info["energy1"].shape == (1, B)
    import copy

    for b in range(B):
        lp_b = copy.deepcopy(lp)
        lp_b.costsvector = C[b].copy()
        ref, _ = lp_b.solve(method="scipy_simplex")
        assert float(np.dot(C[b], X[b])) <= float(np.dot(C[b], ref)) + 2e-2
        assert lp_b.max_constraint_violation(X[b]) < 2e-2


def test_batch_rhs_and_bounds():
    lp = _template(seed=5)
    B = 3
    rng = np.random.RandomState(2)
    m_in = lp.a_inequalities.shape[0]
    BU = lp.b_upper[None, :] + 0.5 * rng.rand(B, m_in)
    UB = np.broadcast_to(lp.upper_bounds * 1.0, (B, lp.nb_variables)).copy()
    UB[1] += 1.0   # loosen (tightening can make the equalities infeasible;
    #                multiplying tightens NEGATIVE upper bounds)
    X, info = solve_cp_batch(lp, b_upper=BU, ub=UB, nb_iter=20000,
                             nb_iter_plot=10000, dtype=np.float64)
    assert X.shape == (B, lp.nb_variables)
    assert info["itrn"].tolist() == [10000, 20000]
    # each element respects ITS bound variant
    for b in range(B):
        assert np.all(X[b] <= UB[b] + 1e-6)
        viol = lp.a_inequalities.tocsr() @ X[b] - BU[b]
        assert float(np.max(viol)) < 2e-2


def test_batch_validation_errors():
    lp = _template()
    with pytest.raises(ValueError, match="at least one batched"):
        solve_cp_batch(lp)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        solve_cp_batch(lp, costs=np.zeros((2, lp.nb_variables)),
                       ub=np.ones((3, lp.nb_variables)))
    lp_eq_only = SparseLP()
    lp_eq_only.add_variables_array(4, 0, 1, costs=np.arange(4.0))
    with pytest.raises(ValueError, match="at least one constraint"):
        solve_cp_batch(lp_eq_only, costs=np.zeros((2, 4)))


def test_lower_xla_backend_choice():
    import scipy.sparse

    from pysparselp_tpu.problem import DiaMatrix

    small = scipy.sparse.random(20, 30, density=0.2, random_state=0,
                                format="csr")
    assert isinstance(_lower_xla(small, jnp.float64), DenseMatrix)
    banded = scipy.sparse.diags(
        [np.ones(9_000_000), np.ones(9_000_000 - 3)], [0, -3]).tocsr()
    assert isinstance(_lower_xla(banded, jnp.float64), DiaMatrix)
    rng = np.random.RandomState(0)
    scattered = scipy.sparse.random(20000, 20000, density=5e-4,
                                    random_state=rng, format="csr")
    assert isinstance(_lower_xla(scattered, jnp.float64), EllMatrix)


def test_xla_dia_matvec_parity():
    import scipy.sparse

    from pysparselp_tpu.problem import DiaMatrix

    rng = np.random.RandomState(4)
    m, n = 60, 75
    a = scipy.sparse.diags(
        [rng.randn(min(m, n)), rng.randn(min(m, n - 5)),
         rng.randn(min(m - 2, n))], [0, 5, -2], shape=(m, n)).tocsr()
    op = DiaMatrix.from_scipy(a, jnp.float64)
    x = rng.randn(n)
    y = rng.randn(m)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               a @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(y))),
                               a.T @ y, atol=1e-12)
    # vmap (the whole point of the class)
    X = rng.randn(4, n)
    Y = jnp.stack([jnp.asarray(a @ xi) for xi in X])
    np.testing.assert_allclose(
        np.asarray(jax.vmap(op.matvec)(jnp.asarray(X))), np.asarray(Y),
        atol=1e-12)


def test_batch_segmentation_matches_graph_cut():
    """Batched Potts serving demo: each frame's thresholded relaxation
    matches its own graph-cut optimum."""
    from pysparselp_tpu.examples.potts import (graph_cut_segmentation,
                                               solve_batch_segmentation)

    rng = np.random.RandomState(3)
    B, size, coef_mul = 3, 12, 500
    imgs = np.round(coef_mul * (rng.rand(B, size, size) * 2 - 1)) / coef_mul
    coef = round(0.5 * coef_mul) / coef_mul
    segs, info = solve_batch_segmentation(imgs, coef, nb_iter=30000,
                                          nb_iter_plot=30000,
                                          dtype=np.float64)
    assert segs.shape == (B, size, size)
    for b in range(B):
        gt = graph_cut_segmentation(imgs[b] * coef_mul,
                                    round(coef * coef_mul))
        agree = np.mean((segs[b] > 0.5) == (gt > 0.5))
        assert agree > 0.97, (b, agree)


def test_lower_xla_partition_and_colsplit():
    """Assignment/simplex patterns lower to the gather-free
    PartitionMatrix, and [diag | hot-columns] shapes to an XLA-safe
    column-split composite — both vmappable (the whole point)."""
    import scipy.sparse

    from pysparselp_tpu.problem import ColBlockMatrix, PartitionMatrix

    # partition rows: too big for dense (m*n > DENSE_AUTO_MAX_ENTRIES)
    m, w = 9000, 30
    rows = np.repeat(np.arange(m), w)
    cols = (np.arange(m)[:, None] * w + np.arange(w)[None, :]).reshape(-1)
    simplex = scipy.sparse.csr_matrix(
        (np.ones(m * w), (rows, cols)), shape=(m, m * w))
    op = _lower_xla(simplex, jnp.float64)
    assert isinstance(op, PartitionMatrix)
    rng = np.random.RandomState(0)
    X = rng.randn(3, m * w)
    ref = np.stack([simplex @ xi for xi in X])
    got = np.asarray(jax.vmap(op.matvec)(jnp.asarray(X)))
    np.testing.assert_allclose(got, ref, atol=1e-12)

    # k-medians-ineq shape: 1-nnz diagonal block + hot dense columns,
    # too big for whole-matrix dense, not banded (the hot columns kill
    # the DIA offset count)
    npts, nc = 70000, 20
    r2 = np.arange(npts)
    labeling = scipy.sparse.csr_matrix(
        (np.ones(npts), (r2, r2)), shape=(npts, npts + nc))
    hot = scipy.sparse.csr_matrix(
        (-np.ones(npts * nc),
         (np.repeat(r2, nc), npts + np.tile(np.arange(nc), npts))),
        shape=(npts, npts + nc))
    a = (labeling + hot).tocsr()
    op2 = _lower_xla(a, jnp.float64)
    assert isinstance(op2, ColBlockMatrix)
    assert all(not type(b).__name__.startswith("Bsr")
               for b in op2.blocks), [type(b).__name__ for b in op2.blocks]
    x = rng.randn(npts + nc)
    np.testing.assert_allclose(np.asarray(op2.matvec(jnp.asarray(x))),
                               a @ x, atol=1e-9)
    X2 = rng.randn(2, npts + nc)
    ref2 = np.stack([a @ xi for xi in X2])
    got2 = np.asarray(jax.vmap(op2.matvec)(jnp.asarray(X2)))
    np.testing.assert_allclose(got2, ref2, atol=1e-9)


def test_batch_assignment_lp_serving():
    """Batched serving of an assignment LP (k-medians shape): B cost
    variants through the partition-eq + col-split-ineq backends agree
    with per-variant single solves."""
    rng = np.random.RandomState(7)
    npts, nc = 50, 6
    dist = rng.rand(npts, nc)
    lp = SparseLP()
    lab = lp.add_variables_array((npts, nc), 0, 1, dist)
    used = lp.add_variables_array(nc, 0, 1, 0)
    lp.add_equality_constraints(lab, np.ones((npts, nc)), b=np.ones(npts))
    cols = np.column_stack(
        (lab.reshape(-1, 1),
         np.ones((npts, 1)).dot(used[None, :]).reshape(-1, 1))).astype(int)
    vals = np.column_stack((np.ones(lab.size), -np.ones(lab.size)))
    lp.add_inequality_constraints(cols, vals, lower_bounds=None,
                                  upper_bounds=0)

    B = 3
    C = lp.costsvector[None, :] * (1.0 + 0.2 * rng.rand(
        B, lp.nb_variables))
    X, info = solve_cp_batch(lp, costs=C, nb_iter=3000, nb_iter_plot=1500,
                             dtype=np.float64)
    for b in range(B):
        lp.costsvector = C[b]
        ref, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=3000,
                          nb_iter_plot=1500, dtype=np.float64)
        np.testing.assert_allclose(np.asarray(X[b]), np.asarray(ref),
                                   atol=2e-4)
