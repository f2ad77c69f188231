"""Anchor-aligned embedding presolve: diagonal collapse + solution parity."""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from pysparselp_tpu.problem import (aligned_offset_count, anchor_align,
                                    dia_offset_count, embed_matrix)
from pysparselp_tpu.solvers.chambolle_pock import (_choose_layout,
                                                   _fold_one_sided,
                                                   chambolle_pock_ppd)


@pytest.fixture(scope="module")
def potts20():
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(20, 0.5, 500)
    return lp


def test_embedding_preserves_entries(potts20):
    a = potts20.a_inequalities.tocsr()
    (_, pos), col_pos, (_, m_new), n_new = anchor_align([None, a])
    emb = embed_matrix(a, pos, col_pos, m_new, n_new)
    assert emb.nnz == a.nnz
    # gathering the embedded rows back recovers the original row sums
    np.testing.assert_allclose(
        np.asarray(emb.sum(axis=1)).ravel()[pos],
        np.asarray(a.sum(axis=1)).ravel(),
    )
    # injectivity
    assert np.unique(pos).size == a.shape[0]
    assert np.unique(col_pos).size == a.shape[1]


def test_diagonal_collapse_on_grid_lp(potts20):
    """The whole point: a grid LP collapses to O(#templates) diagonals,
    where both the raw ordering and RCM scatter them over O(grid side)."""
    a, _ = _fold_one_sided(potts20.a_inequalities.tocsr(),
                           potts20.b_lower, potts20.b_upper)
    raw = dia_offset_count(a)
    counts, m_new, n_new = aligned_offset_count([None, a])
    assert counts[1] <= 24 < raw
    # padded size stays within ~1.5x of the anchor count times slots
    assert m_new[1] <= 1.1 * max(a.shape)


def test_align_solution_matches_unpermuted(potts20):
    a = potts20.a_inequalities.tocsr()
    args = (potts20.costsvector, None, None, a, potts20.b_lower,
            potts20.b_upper, potts20.lower_bounds, potts20.upper_bounds)
    kw = dict(nb_max_iter=600, nb_iter_plot=300, dtype=np.float64)
    x_none, _ = chambolle_pock_ppd(*args, permute=False, **kw)
    x_align, _ = chambolle_pock_ppd(*args, permute="align", **kw)
    np.testing.assert_allclose(x_align, x_none, atol=1e-10)


def test_align_with_equalities_and_warmstart():
    # mixed eq+ineq system through the align path, plus x0 round-trip
    rng = np.random.RandomState(3)
    n = 40
    a_eq = scipy.sparse.random(8, n, density=0.2, random_state=rng,
                               format="csr")
    a_in = scipy.sparse.random(25, n, density=0.15, random_state=rng,
                               format="csr")
    x_feas = rng.rand(n)
    beq = a_eq @ x_feas
    bu = a_in @ x_feas + 0.5
    c = rng.randn(n)
    args = (c, a_eq, beq, a_in, None, bu, np.zeros(n), np.ones(n))
    kw = dict(nb_max_iter=400, nb_iter_plot=200, dtype=np.float64,
              x0=x_feas)
    x_none, _ = chambolle_pock_ppd(*args, permute=False, **kw)
    x_align, _ = chambolle_pock_ppd(*args, permute="align", **kw)
    np.testing.assert_allclose(x_align, x_none, atol=1e-10)


def test_choose_layout_runs(potts20):
    a, _ = _fold_one_sided(potts20.a_inequalities.tocsr(),
                           potts20.b_lower, potts20.b_upper)
    choice, plan = _choose_layout([None, a], jnp.float32)
    assert choice in (None, "rcm", "align")
    # the alignment plan is returned alongside so "align" is applied
    # without re-running the O(nnz log nnz) embedding
    assert (plan is not None) == (choice == "align")
