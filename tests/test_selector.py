"""The layout presolve and operator backends the solver picks for each
bench family (the same selection runs on every backend), and the XLA CP
iteration's eq+ineq and restart trajectories."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from pysparselp_tpu import SparseLP
from pysparselp_tpu.problem import DiaMatrix, LPProblem
from pysparselp_tpu.solvers import chambolle_pock as cpm

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _potts():
    from pysparselp_tpu.examples.potts import build_linear_program

    return build_linear_program(60, 0.5, 500)[0]


def _l1svm():
    from pysparselp_tpu.examples.l1_svm import L1SVM

    rng = np.random.RandomState(1)
    x = rng.rand(1500, 30)
    w = rng.randn(3, 30)
    wh = np.hstack((w, -0.5 * np.sum(w, axis=1)[:, None]))
    classes = np.argmax(np.hstack((x, np.ones((1500, 1)))) @ wh.T, axis=1)
    svm = L1SVM()
    svm.set_data(x, classes, 3)
    return svm


def _unstructured():
    a, b, c = bench._unstructured_matrix(m=6000, n=4000)
    lp = SparseLP()
    lp.add_variables_array(4000, lower_bounds=0, upper_bounds=1, costs=c)
    lp.add_inequality_constraints_sparse(a, None, b)
    return lp


FAMILIES = {
    # family: (builder, layout, eq backend, ineq backend)
    "potts": (_potts, "align", None, "DiaMatrix"),
    "sc105": (lambda: bench._sc105_lp()[0], None, "DenseMatrix",
              "DenseMatrix"),
    "l1svm": (_l1svm, None, None, "ColBlockMatrix"),
    "kmedians": (lambda: bench._kmedians_lp(n_points=1000, n_candidates=30),
                 None, "PartitionMatrix", "SegmentedEllMatrix"),
    "transport": (lambda: bench._transport_lp(2000, 2000, 40000), None,
                  "SegmentedEllMatrix", "DenseMatrix"),
    "unstructured": (_unstructured, None, None, "SegmentedEllMatrix"),
    "banded": (lambda: bench._banded_lp(n=6000), None, None, "DiaMatrix"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_selector_per_bench_family(family):
    build, layout, eq, ineq = FAMILIES[family]
    lp = build()
    lp.solve(method="chambolle_pock_ppd", nb_iter=2, nb_iter_plot=2,
             dtype=np.float32)
    plan = cpm.last_plan
    assert (plan["layout"], plan["eq"], plan["ineq"]) == (layout, eq, ineq)


def _dia_problem(n, seed, m_eq=None, offs=(-3, 0, 5, 130),
                 eq_offs=(-7, 0, 64)):
    """Banded CP problem in f64 with an inequality system and, when
    ``m_eq`` is given, an equality system of another band."""
    rng = np.random.RandomState(seed)
    a = scipy.sparse.diags([rng.rand(n) * 2 - 1 for _ in offs], offs,
                           shape=(n, n)).tocsr()
    ae = None
    if m_eq is not None:
        ae = scipy.sparse.diags([rng.rand(n) * 2 - 1 for _ in eq_offs],
                                eq_offs, shape=(m_eq, n)).tocsr()
    xf = rng.rand(n)
    c = rng.rand(n) - 0.3
    lb, ub = np.zeros(n), np.ones(n) * 2
    b_eq = ae @ xf if ae is not None else None
    b_up = a @ xf + rng.rand(n)
    return c, ae, b_eq, a, b_up, lb, ub


CASES = {
    "ineq": dict(n=900, seed=0),
    "eq_ineq": dict(n=900, seed=1, m_eq=900),
    "eq_rectangular": dict(n=700, seed=4, m_eq=820),
    "one_sided_offsets": dict(n=2600, seed=5, offs=(1200, 1203, 1300)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_chunk_matches_plain_cp(case):
    """The solver's fused XLA chunk on DIA operators equals the plain
    scipy CP loop (f64): eq+ineq, rectangular eq, one-sided offsets."""
    c, ae, b_eq, a, b_up, lb, ub = _dia_problem(**CASES[case])
    prob, pre = cpm.build_cp_problem(
        c, ae, b_eq, a, b_up, lb, ub, jnp.float64,
        lower=lambda m, dtype: DiaMatrix.from_scipy(m, dtype))
    assert isinstance(prob, LPProblem)
    x0 = jnp.zeros(prob.n)
    state = (x0, x0, jnp.zeros(prob.m_eq), jnp.zeros(prob.m_ineq))
    got, _ = cpm._cp_chunk(prob, pre, state, 60)
    xr, yer, yir = chip_smoke.plain_cp(c, ae, b_eq, a, b_up, lb, ub, 60)
    np.testing.assert_allclose(np.asarray(got[0]), xr, atol=1e-10)
    np.testing.assert_allclose(np.asarray(got[3]), yir, atol=1e-10)
    if ae is not None:
        np.testing.assert_allclose(np.asarray(got[2]), yer, atol=1e-10)


def _restart_state(prob):
    x0 = jnp.zeros(prob.n)
    ye, yi = jnp.zeros(prob.m_eq), jnp.zeros(prob.m_ineq)
    return {
        "state": (x0, x0, ye, yi),
        "omega": jnp.asarray(1.0),
        "mu_restart": cpm._kkt_score(prob, x0, ye, yi),
        "mu_last": jnp.asarray(np.inf),
        "zx": x0, "zeq": ye, "zineq": yi,
    }


@pytest.mark.parametrize("case", ["ineq", "eq_ineq"])
def test_restart_controller_chunking_invariance(case):
    """The device restart controller over 45 iterations (checks at 20 and
    40) equals 20 then 25 iterations: blocks restart at the same points,
    carrying ω, the restart scores and the restart point across calls."""
    c, ae, b_eq, a, b_up, lb, ub = _dia_problem(**CASES[case])
    prob, pre = cpm.build_cp_problem(c, ae, b_eq, a, b_up, lb, ub,
                                     jnp.float64)
    rs0 = _restart_state(prob)
    r45, m45 = cpm._cp_chunk_restart_device(prob, pre, rs0, 45, 20)
    r20, _ = cpm._cp_chunk_restart_device(prob, pre, rs0, 20, 20)
    r2025, m2025 = cpm._cp_chunk_restart_device(prob, pre, r20, 25, 20)
    for k in r45:
        a_, b_ = r45[k], r2025[k]
        for u, v in zip(a_ if isinstance(a_, tuple) else (a_,),
                        b_ if isinstance(b_, tuple) else (b_,)):
            np.testing.assert_allclose(np.asarray(v), np.asarray(u),
                                       atol=1e-12)
    np.testing.assert_allclose(float(m2025["energy1"]),
                               float(m45["energy1"]), rtol=1e-12)


def test_restart_solver_converges_on_eq_ineq_band():
    """restart="average" through the solver on an eq+ineq DIA system
    reaches a smaller KKT score than the plain iteration."""
    c, ae, b_eq, a, b_up, lb, ub = _dia_problem(n=600, seed=3, m_eq=600)
    kw = dict(nb_max_iter=3000, nb_iter_plot=500, dtype=jnp.float64)
    args = (c, ae, b_eq, a, None, b_up, lb, ub)
    x_plain, _ = cpm.chambolle_pock_ppd(*args, **kw)
    x_rst, _ = cpm.chambolle_pock_ppd(*args, restart="average", **kw)
    prob, _ = cpm.build_cp_problem(c, ae, b_eq, a, b_up, lb, ub,
                                   jnp.float64)

    def viol(x):
        return (np.abs(ae @ x - b_eq).max()
                + np.maximum(a @ x - b_up, 0).max())

    assert viol(x_rst) < viol(x_plain)
    assert prob.m_eq == 600
