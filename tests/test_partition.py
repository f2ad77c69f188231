"""PartitionMatrix: the assignment/simplex-row operator (reshape +
multiply-reduce, no gathers) and its detection + chooser integration.

Target shape: uniform-width contiguous-column rows advancing by a fixed
stride — simplex rows of assignment LPs (k-medians,
``reference/pysparselp/examples/example_kmedians.py:40-44``), one-hot
label sums, transport-LP source equalities over arc blocks."""

import numpy as np
import pytest
import scipy.sparse

import jax
import jax.numpy as jnp

import pysparselp_tpu.problem as pr


def _partition_csr(m=40, w=6, stride=None, col0=0, n_extra=5, seed=0):
    stride = w if stride is None else stride
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(m), w)
    cols = col0 + (np.arange(m)[:, None] * stride
                   + np.arange(w)[None, :]).reshape(-1)
    vals = rng.randn(m * w)
    n = col0 + (m - 1) * stride + w + n_extra
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(m, n))


def test_geometry_detection():
    assert pr.partition_geometry(_partition_csr()) == (0, 6, 6)
    assert pr.partition_geometry(
        _partition_csr(stride=9, col0=17)) == (17, 9, 6)
    # single row: trivially a partition
    assert pr.partition_geometry(_partition_csr(m=1)) == (0, 6, 6)
    # non-uniform width
    a = _partition_csr().tolil()
    a[0, -1] = 3.0
    assert pr.partition_geometry(a.tocsr()) is None
    # uniform width but non-contiguous columns
    rows = np.repeat(np.arange(10), 2)
    cols = np.tile(np.array([0, 5]), 10) + np.repeat(np.arange(10), 2)
    b = scipy.sparse.csr_matrix((np.ones(20), (rows, cols)), shape=(10, 20))
    assert pr.partition_geometry(b) is None
    # overlapping runs (stride < width) cannot reshape
    rows = np.repeat(np.arange(5), 4)
    cols = (np.arange(5)[:, None] * 2 + np.arange(4)[None, :]).reshape(-1)
    c = scipy.sparse.csr_matrix((np.ones(20), (rows, cols)), shape=(5, 12))
    assert pr.partition_geometry(c) is None
    # irregular stride
    d = scipy.sparse.block_diag(
        [np.ones((1, 3)), np.ones((1, 3))], format="csr")
    e = scipy.sparse.hstack(
        [d, scipy.sparse.csr_matrix((2, 1))]).tocsr()
    assert pr.partition_geometry(e) == (0, 3, 3)


@pytest.mark.parametrize("stride,col0", [(None, 0), (9, 17)])
def test_protocol_parity(stride, col0):
    a = _partition_csr(stride=stride, col0=col0, seed=3)
    op = pr.PartitionMatrix.from_scipy(a)
    x = np.random.RandomState(1).randn(a.shape[1])
    y = np.random.RandomState(2).randn(a.shape[0])
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               a @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(y))),
                               a.T @ y, atol=1e-12)
    for p in (0.0, 1.0, 2.0):
        ref = a.copy()
        ref.data = np.where(np.abs(ref.data) > 0, np.abs(ref.data) ** p,
                            0.0)
        np.testing.assert_allclose(
            np.asarray(op.abs_power_rowsum(p)),
            np.asarray(ref.sum(axis=1)).ravel(), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(op.abs_power_colsum(p)),
            np.asarray(ref.sum(axis=0)).ravel(), atol=1e-12)
    d = np.random.RandomState(4).rand(a.shape[1])
    np.testing.assert_allclose(
        np.asarray(op.sq_rowsum_weighted(jnp.asarray(d))),
        np.asarray(a.multiply(a) @ d).ravel(), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a.toarray(),
                               atol=1e-12)
    assert op.shape == a.shape
    assert op.nnz_padded == a.nnz


def test_f32_reductions_stay_f32_under_x64():
    """Regression: abs_power_* must not promote to f64 under
    jax_enable_x64 — a single f64 preconditioner vector poisons every
    carry in the CP fori_loop (observed on chip: 'carry input and carry
    output must have equal types' on the k-medians solve)."""
    a = _partition_csr(seed=9)
    op = pr.PartitionMatrix.from_scipy(a, dtype=jnp.float32)
    for p in (0.0, 1.0, 2.0):
        assert op.abs_power_rowsum(p).dtype == jnp.float32
        assert op.abs_power_colsum(p).dtype == jnp.float32
    x32 = jnp.ones(a.shape[1], jnp.float32)
    y32 = jnp.ones(a.shape[0], jnp.float32)
    assert op.matvec(x32).dtype == jnp.float32
    assert op.rmatvec(y32).dtype == jnp.float32
    assert op.sq_rowsum_weighted(x32).dtype == jnp.float32


def test_prefer_partition_and_rejection():
    a = _partition_csr(seed=5)
    op = pr.ell_from_scipy(a, prefer="partition")
    assert isinstance(op, pr.PartitionMatrix)
    bad = scipy.sparse.random(30, 30, density=0.1, random_state=0,
                              format="csr")
    with pytest.raises(ValueError):
        pr.ell_from_scipy(bad, prefer="partition")


def test_chooser_selects_partition():
    """A simplex-row block must price and lower to PartitionMatrix (the
    k-medians eq shape lowers to BSR at 78 MB without this operator —
    43x the partition bill)."""
    m, w = 5000, 30
    rows = np.repeat(np.arange(m), w)
    cols = (np.arange(m)[:, None] * w + np.arange(w)[None, :]).reshape(-1)
    a = scipy.sparse.csr_matrix((np.ones(m * w), (rows, cols)),
                                shape=(m, m * w + 30))
    best, cost = pr.estimate_stream_bytes(a, jnp.float32)
    assert best == "partition"
    assert cost < 4e6, cost
    op = pr.ell_from_scipy(a, dtype=jnp.float32)
    assert isinstance(op, pr.PartitionMatrix)
    # bf16 storage: the all-ones table is exactly representable
    assert op.vals.dtype == jnp.bfloat16
    x = np.random.RandomState(0).randn(a.shape[1]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               a @ x, rtol=1e-4, atol=1e-5)


def test_kmedians_shape_lowering_budget():
    """The k-medians system lowers to the exact-boundary col-split
    ([DIA | dense] at the labeling|used boundary) plus a partition eq."""
    from pysparselp_tpu.solvers.chambolle_pock import _fold_one_sided

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", str(__import__("pathlib").Path(__file__).parent.parent
                     / "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    lp = bench._kmedians_lp(n_points=500, n_candidates=30)
    a1, _ = _fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower,
                            lp.b_upper)
    ae = lp.a_equalities.tocsr()
    assert pr.partition_geometry(ae) is not None
    op = pr.ell_from_scipy(a1, dtype=jnp.float32)
    op_e = pr.ell_from_scipy(ae, dtype=jnp.float32)
    assert isinstance(op_e, pr.PartitionMatrix)
    # the exact cut lands at the labeling|used boundary, but the hot used
    # columns gather cheaply: the [DIA | dense] split does not clear the
    # gain gate against segmented ELL
    _, whole = pr.estimate_stream_bytes(a1, jnp.float32)
    split, cuts = pr.col_split_plan(a1, jnp.float32)
    assert cuts == (500 * 30,)
    assert split >= pr.COL_SPLIT_MIN_GAIN * whole
    assert isinstance(op, pr.SegmentedEllMatrix), type(op).__name__


def test_cp_solve_parity_with_partition_eq():
    """A small assignment LP solves identically through the partition
    backend and the generic path (public API, CP flagship)."""
    from pysparselp_tpu import SparseLP

    rng = np.random.RandomState(7)
    npts, nc = 40, 5
    cost = rng.rand(npts, nc)
    lp = SparseLP()
    lab = lp.add_variables_array((npts, nc), 0, 1, cost)
    lp.add_equality_constraints(lab, np.ones((npts, nc)),
                                b=np.ones(npts))
    ref, _ = lp.solve(method="scipy_simplex")
    sol, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=8000,
                      nb_iter_plot=1000)
    assert abs(lp.cost(sol) - lp.cost(ref)) < 1e-2
    # the eq matrix partition-detects and the operator reproduces the
    # same matvec the solver used
    ae = lp.a_equalities.tocsr()
    assert pr.partition_geometry(ae) == (0, nc, nc)
    op = pr.PartitionMatrix.from_scipy(ae)
    x = np.asarray(sol)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))),
                               ae @ x, atol=1e-9)
