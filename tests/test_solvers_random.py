"""End-to-end solver tests on random feasible LPs vs scipy HiGHS ground truth.

This is the property-test analogue of the reference's random-LP benchmark
driver (``pysparselp/randomLP.py:78-118``) turned into assertions: every
iterative solver must approach the scipy optimum on a small seeded problem.
"""

import copy

import numpy as np
import pytest

from pysparselp_tpu import SparseLP, solving_methods
from pysparselp_tpu.utils.random_lp import generate_random_lp


@pytest.fixture(scope="module")
def random_problem():
    lp, _ = generate_random_lp(nbvar=30, n_eq=2, n_ineq=30, sparsity=0.2, seed=10)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    x_gt = lp2.solve(method="scipy_simplex", get_timing=False)
    assert lp2.max_constraint_violation(x_gt) < 1e-8
    return lp2, x_gt


def test_chambolle_pock_converges(random_problem):
    lp, x_gt = random_problem
    cost_gt = lp.costsvector @ x_gt
    x, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=20000, nb_iter_plot=5000)
    assert lp.max_constraint_violation(x) < 1e-3
    assert abs(lp.costsvector @ x - cost_gt) < 5e-2 * max(1, abs(cost_gt))


def test_chambolle_pock_records_curves(random_problem):
    lp, x_gt = random_problem
    lp.solve(
        method="chambolle_pock_ppd", nb_iter=100, nb_iter_plot=10,
        ground_truth=x_gt, ground_truth_indices=np.arange(len(x_gt)),
    )
    assert len(lp.itrn_curve) == 10
    assert len(lp.distance_to_ground_truth) == 10
    assert len(lp.opttime_curve) == 10
    assert lp.itrn_curve[-1] == 100
    # distances should be decreasing overall
    assert lp.distance_to_ground_truth[-1] < lp.distance_to_ground_truth[0]


def test_solver_registry():
    for m in ("chambolle_pock_ppd", "admm", "admm2", "admm_blocks", "mehrotra",
              "dual_coordinate_ascent", "dual_gradient_ascent",
              "scipy_simplex", "scipy_interior_point"):
        assert m in solving_methods


def test_unknown_method_raises():
    lp = SparseLP()
    lp.add_variables_array(2, 0, 1, costs=1.0)
    with pytest.raises(ValueError):
        lp.solve(method="nope")


def test_mehrotra_warns_below_float64():
    """Interior point needs f64; sub-f64 dtypes warn instead of silently
    stalling at a coarse tolerance (observed with the f32 default)."""
    import warnings

    import scipy.sparse

    from pysparselp_tpu.solvers.mehrotra import mpc_sol

    a = scipy.sparse.eye(4, format="csr")
    b = np.ones(4)
    c = np.ones(4)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        mpc_sol(a, b, c, max_iter=2, dtype=np.float32)
    assert any("float64" in str(w.message) for w in rec)
