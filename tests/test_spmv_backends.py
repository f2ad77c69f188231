"""Every XLA operator backend against scipy, both SpMV directions.

The sparsity patterns are the ones that stress a gather-free lowering:
uniform random at three densities, a duplicate-heavy (hot) column, empty
and dense rows together, one deep row, and Poisson-distributed row
lengths.  Each backend runs in float64, float32 and float32 with
bf16-exact entries (stored as bf16 planes/tiles where the backend does).
"""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from pysparselp_tpu import problem as pr


def _uniform(density):
    def make(rng):
        return scipy.sparse.random(60, 48, density=density,
                                   random_state=rng, format="csr")
    return make


def _hot_column(rng):
    m, n = 60, 40
    hot = scipy.sparse.csr_matrix((np.ones(m), (np.arange(m),
                                                np.full(m, 7))), shape=(m, n))
    return (hot + scipy.sparse.random(m, n, density=0.03,
                                      random_state=rng)).tocsr()


def _empty_and_dense_rows(rng):
    a = scipy.sparse.lil_matrix((32, 50))
    a[10, :] = rng.randn(50)
    a[20, 5] = 3.0
    return a.tocsr()


def _deep_row(rng):
    a = scipy.sparse.random(70, 45, density=0.02, random_state=rng,
                            format="lil")
    a[3, :] = rng.randn(45)
    return a.tocsr()


def _poisson_rows(rng):
    m, n = 80, 60
    counts = np.minimum(rng.poisson(3.0, m), n)
    rows = np.repeat(np.arange(m), counts)
    cols = np.concatenate([rng.choice(n, c, replace=False) for c in counts])
    return scipy.sparse.csr_matrix((rng.randn(rows.size), (rows, cols)),
                                   shape=(m, n))


PATTERNS = {
    "uniform_sparse": _uniform(0.02),
    "uniform_medium": _uniform(0.1),
    "uniform_dense": _uniform(0.4),
    "hot_column": _hot_column,
    "empty_and_dense_rows": _empty_and_dense_rows,
    "deep_row": _deep_row,
    "poisson_rows": _poisson_rows,
}
BACKENDS = ["dense", "dia", "bsr", "ell", "segmented", "split"]
DTYPES = ["f64", "f32", "bf16exact"]


def _case(pattern, dtype):
    rng = np.random.RandomState(sum(map(ord, pattern)))
    a = PATTERNS[pattern](rng).tocsr()
    a.sum_duplicates()
    if dtype == "bf16exact":
        a.data = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], size=a.nnz)
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    return a, jdt


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_spmv_matches_scipy(backend, pattern, dtype):
    a, jdt = _case(pattern, dtype)
    op = pr.ell_from_scipy(a, dtype=jdt, prefer=backend)
    if backend in ("dia", "bsr") and dtype == "bf16exact":
        vals = op.vals if backend == "dia" else op.tiles
        assert vals.dtype == jnp.bfloat16
    rng = np.random.RandomState(1)
    x = rng.randn(a.shape[1])
    y = rng.randn(a.shape[0])
    tol = 1e-12 if dtype == "f64" else 2e-5
    xs, ys = (x, y) if dtype == "f64" else (x.astype(np.float32),
                                           y.astype(np.float32))
    got = np.asarray(op.matvec(jnp.asarray(xs, jdt)), np.float64)
    got_t = np.asarray(op.rmatvec(jnp.asarray(ys, jdt)), np.float64)
    ref = a @ xs.astype(np.float64)
    ref_t = a.T @ ys.astype(np.float64)
    scale = 1.0 + np.abs(a).sum()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(got_t, ref_t, rtol=tol, atol=tol * scale)
    assert got.shape == (a.shape[0],) and got_t.shape == (a.shape[1],)
