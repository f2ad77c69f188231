"""Diagonal (DIA) operator backend: correctness vs scipy."""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from pysparselp_tpu.problem import DiaMatrix, dia_offset_count, ell_from_scipy


def _banded(m, n, offsets, seed):
    rng = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(m, n - off))
        rows.append(r)
        cols.append(r + off)
        vals.append(rng.randn(r.size))
    return scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n),
    ).tocsr()


SHAPES = [
    (40, 40, (-3, 0, 2)),
    (50, 30, (0, 5, 17)),
    (30, 80, (-10, 0, 1, 49)),
    (7, 7, (0,)),
]


@pytest.mark.parametrize("m,n,offsets", SHAPES)
def test_dia_matches_scipy(m, n, offsets):
    a = _banded(m, n, offsets, seed=m + n)
    d = DiaMatrix.from_scipy(a, dtype=jnp.float64)
    assert d.offsets == tuple(sorted(offsets))
    x = np.random.RandomState(0).randn(n)
    y = np.random.RandomState(1).randn(m)
    np.testing.assert_allclose(np.asarray(d.matvec(jnp.asarray(x))), a @ x,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d.rmatvec(jnp.asarray(y))),
                               a.T @ y, rtol=1e-12, atol=1e-12)


def test_dia_reductions_and_dense():
    a = _banded(35, 25, (-2, 0, 7), seed=3)
    d = DiaMatrix.from_scipy(a, dtype=jnp.float64)
    ad = np.abs(a.toarray())
    np.testing.assert_allclose(np.asarray(d.abs_power_rowsum(1.5)),
                               (ad**1.5).sum(1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(d.abs_power_colsum(0.5)),
                               (ad**0.5).sum(0), rtol=1e-12)
    w = np.random.RandomState(2).rand(25)
    np.testing.assert_allclose(
        np.asarray(d.sq_rowsum_weighted(jnp.asarray(w))),
        (a.toarray() ** 2) @ w, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(d.to_dense()), a.toarray(),
                               rtol=1e-12)


def test_dia_offset_count_and_prefer():
    a = _banded(60, 60, (-1, 0, 1), seed=5)
    assert dia_offset_count(a) == 3
    d = ell_from_scipy(a, dtype=jnp.float64, prefer="dia")
    assert isinstance(d, DiaMatrix)


def test_dia_duplicate_entries_summed():
    a = scipy.sparse.coo_matrix(
        ([1.0, 2.0], ([0, 0], [1, 1])), shape=(3, 3)
    )
    d = DiaMatrix.from_scipy(a)
    x = np.array([1.0, 1.0, 1.0])
    np.testing.assert_allclose(np.asarray(d.matvec(jnp.asarray(x))),
                               [3.0, 0.0, 0.0])


def test_dia_solver_end_to_end():
    """CP-PPD on the DIA backend matches the ELL backend bitwise-closely."""
    import copy

    from pysparselp_tpu.solvers import chambolle_pock as cp_mod
    from pysparselp_tpu.utils.random_lp import generate_random_lp

    lp, _ = generate_random_lp(nbvar=40, n_eq=3, n_ineq=40, sparsity=0.2,
                               seed=4)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()

    def solve(prefer):
        orig = cp_mod.ell_from_scipy
        cp_mod.ell_from_scipy = lambda a, **kw: orig(
            a, **{**kw, "prefer": prefer})
        try:
            x, _ = cp_mod.chambolle_pock_ppd(
                lp2.costsvector, lp2.a_equalities.tocsr(), lp2.b_equalities,
                lp2.a_inequalities.tocsr(), None, lp2.b_upper,
                lp2.lower_bounds, lp2.upper_bounds,
                nb_max_iter=2000, nb_iter_plot=2000,
            )
        finally:
            cp_mod.ell_from_scipy = orig
        return x

    np.testing.assert_allclose(solve("dia"), solve("ell"), atol=1e-9)


def test_dia_bf16_exact_storage():
    a = _banded(60, 60, (-1, 0, 1), seed=8)
    a.data = np.sign(a.data) * 1.0
    d = DiaMatrix.from_scipy(a, dtype=jnp.float32)
    assert d.vals.dtype == jnp.bfloat16
    x = np.random.RandomState(0).randn(60).astype(np.float32)
    y = np.asarray(d.matvec(jnp.asarray(x)), np.float64)
    ref = a @ x.astype(np.float64)
    assert np.abs(y - ref).max() < 1e-5
    np.testing.assert_allclose(np.asarray(d.abs_power_rowsum(1.0)),
                               np.abs(a.toarray()).sum(1), rtol=1e-6)


def _random_dia(m, n, ndiag, seed, frac=0.6):
    rng = np.random.RandomState(seed)
    offs = rng.choice(np.arange(-m + 1, n), size=min(ndiag, m + n - 1),
                      replace=False)
    rows, cols, vals = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), min(m, n - o))
        r = r[rng.rand(r.size) < frac]
        rows.append(r)
        cols.append(r + o)
        vals.append(rng.randn(r.size))
    return scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n)).tocsr()


@pytest.mark.parametrize("m,n,ndiag,seed", [
    (130, 257, 9, 0),       # unaligned shapes, both signs of offsets
    (64, 64, 5, 1),         # tiny
    (700, 300, 25, 2),      # wide-landscape, many diagonals
    (300, 700, 17, 3),      # portrait; offsets beyond +/-128
])
def test_dia_f32_random_offsets_match_scipy(m, n, ndiag, seed):
    """Partially filled random diagonals in f32, both directions."""
    a = _random_dia(m, n, ndiag, seed)
    dia = DiaMatrix.from_scipy(a, dtype=jnp.float32, allow_bf16=False)
    assert dia.vals.shape == (dia.ndiag, m)
    assert dia.vals_t.shape == (dia.ndiag_t, n)
    x = np.random.RandomState(seed + 100).randn(n).astype(np.float32)
    y = np.random.RandomState(seed + 200).randn(m).astype(np.float32)
    np.testing.assert_allclose(np.asarray(dia.matvec(jnp.asarray(x))),
                               a @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(dia.rmatvec(jnp.asarray(y))),
                               a.T @ y, rtol=2e-5, atol=2e-5)
