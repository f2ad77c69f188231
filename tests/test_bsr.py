"""Block-ELL operator backend: correctness vs scipy."""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from pysparselp_tpu.ops.bsr import BsrMatrix, bsr_padded_entries


def _random_sparse(m, n, density, seed, clustered=False):
    rng = np.random.RandomState(seed)
    if clustered:
        # band + random block structure: the layout BSR is designed for
        rows = np.arange(m).repeat(3)
        cols = np.clip(
            rows // 3 * n // m + rng.randint(-2, 3, rows.size), 0, n - 1
        )
        vals = rng.randn(rows.size)
        a = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n))
        return a.tocsr()
    return scipy.sparse.random(m, n, density=density, random_state=rng,
                               format="csr")


SHAPES = [(5, 7), (128, 128), (130, 260), (300, 50), (1, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bsr_matches_scipy_einsum_path(shape):
    m, n = shape
    a = _random_sparse(m, n, 0.1, seed=m + n)
    b = BsrMatrix.from_scipy(a, dtype=jnp.float64, tm=16, tn=16)
    x = np.random.RandomState(0).randn(n)
    y = np.random.RandomState(1).randn(m)
    np.testing.assert_allclose(np.asarray(b.matvec(jnp.asarray(x))),
                               a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(b.rmatvec(jnp.asarray(y))),
                               a.T @ y, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(128, 128), (200, 300)])
def test_bsr_f32_default_tiles(shape):
    """f32 at the default 64-wide tiles matches scipy."""
    m, n = shape
    a = _random_sparse(m, n, 0.05, seed=3)
    b = BsrMatrix.from_scipy(a, dtype=jnp.float32, tm=64, tn=64)
    x = np.random.RandomState(0).randn(n).astype(np.float32)
    y = np.random.RandomState(1).randn(m).astype(np.float32)
    np.testing.assert_allclose(np.asarray(b.matvec(jnp.asarray(x))),
                               (a @ x.astype(np.float64)), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(b.rmatvec(jnp.asarray(y))),
                               (a.T @ y.astype(np.float64)), rtol=2e-5,
                               atol=2e-5)


def test_bsr_reductions_and_dense():
    a = _random_sparse(90, 70, 0.08, seed=5)
    b = BsrMatrix.from_scipy(a, dtype=jnp.float64, tm=32, tn=16)
    ad = np.abs(a.toarray())
    np.testing.assert_allclose(np.asarray(b.abs_power_rowsum(1.5)),
                               (ad**1.5).sum(1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(b.abs_power_colsum(0.5)),
                               (ad**0.5).sum(0), rtol=1e-12)
    d = np.random.RandomState(2).rand(70)
    np.testing.assert_allclose(np.asarray(b.sq_rowsum_weighted(jnp.asarray(d))),
                               (a.toarray() ** 2) @ d, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(b.to_dense()), a.toarray(),
                               rtol=1e-12)


def test_bsr_clustered_padding_is_efficient():
    a = _random_sparse(4096, 4096, None, seed=7, clustered=True)
    padded = bsr_padded_entries(a)
    # banded structure tiles under the auto-selection dense fraction
    assert padded < 0.25 * 4096 * 4096


def test_bsr_solver_end_to_end():
    """CP-PPD run entirely on the BSR backend matches the default backend."""
    import copy

    from pysparselp_tpu.solvers.chambolle_pock import chambolle_pock_ppd
    from pysparselp_tpu.utils.random_lp import generate_random_lp

    lp, _ = generate_random_lp(nbvar=40, n_eq=3, n_ineq=40, sparsity=0.2,
                               seed=4)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()

    def solve(prefer):
        import pysparselp_tpu.problem as prob_mod
        orig = prob_mod.ell_from_scipy
        try:
            prob_mod.ell_from_scipy = (
                lambda a, **kw: orig(a, **{**kw, "prefer": prefer})
            )
            import pysparselp_tpu.solvers.chambolle_pock as cp_mod
            cp_orig = cp_mod.ell_from_scipy
            cp_mod.ell_from_scipy = prob_mod.ell_from_scipy
            try:
                x, _ = chambolle_pock_ppd(
                    lp2.costsvector, lp2.a_equalities.tocsr(),
                    lp2.b_equalities, lp2.a_inequalities.tocsr(),
                    None, lp2.b_upper, lp2.lower_bounds, lp2.upper_bounds,
                    nb_max_iter=2000, nb_iter_plot=2000,
                )
            finally:
                cp_mod.ell_from_scipy = cp_orig
        finally:
            prob_mod.ell_from_scipy = orig
        return x

    x_bsr = solve("bsr")
    x_ell = solve("ell")
    np.testing.assert_allclose(x_bsr, x_ell, atol=1e-9)


def test_bsr_bf16_exact_storage():
    """f32 matrices with bf16-exact entries store bf16 tiles; widening the
    tiles before the contraction keeps matvec at f32-grade accuracy."""
    rng = np.random.RandomState(0)
    a = _random_sparse(200, 150, 0.05, seed=9)
    a.data = np.sign(a.data) * 0.5  # exactly representable
    b = BsrMatrix.from_scipy(a, dtype=jnp.float32, tm=64, tn=64)
    assert b.tiles.dtype == jnp.bfloat16
    x = rng.randn(150).astype(np.float32)
    y = np.asarray(b.matvec(jnp.asarray(x)), np.float64)
    ref = a @ x.astype(np.float64)
    assert np.abs(y - ref).max() < 1e-5 * max(np.abs(ref).max(), 1.0)
    z = np.asarray(b.rmatvec(jnp.asarray(rng.randn(200).astype(np.float32))))
    assert z.shape == (150,)
    # reductions stay exact
    np.testing.assert_allclose(np.asarray(b.abs_power_rowsum(1.0)),
                               np.abs(a.toarray()).sum(1), rtol=1e-6)
    # non-exact data stays f32
    a2 = _random_sparse(64, 64, 0.1, seed=10)
    b2 = BsrMatrix.from_scipy(a2, dtype=jnp.float32)
    assert b2.tiles.dtype == jnp.float32
