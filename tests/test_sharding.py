"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import copy

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from pysparselp_tpu.parallel.mesh import default_mesh
from pysparselp_tpu.parallel.sharded_cp import (
    build_sharded_cp_data,
    chambolle_pock_ppd_sharded,
    sharded_cp_chunk,
)
from pysparselp_tpu.utils.random_lp import generate_random_lp


@pytest.fixture(scope="module")
def problem():
    lp, _ = generate_random_lp(nbvar=30, n_eq=2, n_ineq=30, sparsity=0.2,
                               seed=10)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    return lp2


def test_sharded_cp_matches_single_device(problem):
    lp = problem
    x1, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=5000,
                     nb_iter_plot=5000)
    mesh = default_mesh(8)
    x8 = chambolle_pock_ppd_sharded(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
        lp.lower_bounds, lp.upper_bounds, mesh,
        nb_max_iter=5000, nb_iter_plot=5000, dtype=np.float64,
    )
    np.testing.assert_allclose(x8, x1, atol=1e-10)


def _sharded_solution(lp, ndev):
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    return chambolle_pock_ppd_sharded(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
        lp.lower_bounds, lp.upper_bounds, mesh,
        nb_max_iter=1000, nb_iter_plot=1000, dtype=np.float64,
    )


@pytest.fixture(scope="module")
def single_device_solution(problem):
    return _sharded_solution(problem, 1)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_cp_device_count_invariance(problem, single_device_solution,
                                            ndev):
    """The algorithm must be independent of the mesh size."""
    x = _sharded_solution(problem, ndev)
    np.testing.assert_allclose(x, single_device_solution, atol=1e-9)


def test_sharded_cp_warm_start(problem):
    """x0 reaches the sharded solver and matches the single-chip warm run."""
    lp = problem
    ref, _ = lp.solve(method="scipy_simplex")
    mesh = default_mesh(8)
    x8 = chambolle_pock_ppd_sharded(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
        lp.lower_bounds, lp.upper_bounds, mesh,
        nb_max_iter=500, nb_iter_plot=500, dtype=np.float64, x0=ref,
    )
    x1, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=500,
                     nb_iter_plot=500, x0=ref)
    # matches the single-chip warm trajectory (which test_instrumentation
    # proves differs from the cold one), so x0 was actually used
    np.testing.assert_allclose(x8, x1, atol=1e-10)


def test_sharded_state_is_actually_sharded(problem):
    lp = problem
    mesh = default_mesh(8)
    data, state = build_sharded_cp_data(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_upper,
        lp.lower_bounds, lp.upper_bounds, mesh, dtype=np.float64,
    )
    state, _m = sharded_cp_chunk(data, state, mesh, 2)
    # dual state is row-sharded over 8 devices; primal is replicated
    y_shard = state["y_ineq"].sharding
    assert len(y_shard.device_set) == 8
    assert state["x"].sharding.is_fully_replicated


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out_state, metrics = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out_state[0])))
    assert np.isfinite(float(metrics["energy1"]))


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_solve_dispatch_with_mesh(problem):
    """lp.solve(method='chambolle_pock_ppd', mesh=...) routes to the
    row-sharded multi-chip solver and matches the single-device result."""
    lp = problem
    x1, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=3000,
                     nb_iter_plot=3000)
    mesh = default_mesh(8)
    x8, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=3000,
                     nb_iter_plot=3000, mesh=mesh, dtype=np.float64)
    np.testing.assert_allclose(x8, x1, atol=1e-10)
    assert len(lp.itrn_curve) == 1


def test_sharded_restart_accelerates(problem):
    """Multi-chip restart+omega mirrors the single-chip acceleration.

    The trajectories are not bitwise comparable (different operator
    layouts → different rounding → threshold-based restart decisions can
    flip), so both are held to the same solution-quality bar instead.
    """
    lp = problem
    mesh = default_mesh(8)
    x8 = chambolle_pock_ppd_sharded(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
        lp.lower_bounds, lp.upper_bounds, mesh,
        nb_max_iter=3000, nb_iter_plot=500, dtype=np.float64,
        restart="average",
    )
    x1, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=3000,
                     nb_iter_plot=500, restart="average")
    ref, _ = lp.solve(method="scipy_simplex")
    assert np.mean(np.abs(x8 - ref)) < 1e-2
    assert np.mean(np.abs(x1 - ref)) < 1e-2


def test_sharded_cp_moderate_scale():
    """A larger row-sharded solve (uneven rows across 8 devices, padding in
    play) stays finite and strictly improves the objective."""
    lp, _ = generate_random_lp(nbvar=300, n_eq=10, n_ineq=1501,
                               sparsity=0.02, seed=11)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    mesh = default_mesh(8)
    stats = []
    x = chambolle_pock_ppd_sharded(
        lp2.costsvector, lp2.a_equalities.tocsr(), lp2.b_equalities,
        lp2.a_inequalities.tocsr(), lp2.b_lower, lp2.b_upper,
        lp2.lower_bounds, lp2.upper_bounds, mesh,
        nb_max_iter=2000, nb_iter_plot=500, dtype=np.float64,
        callback_func=lambda niter, sol, e1, *_: stats.append(float(e1)),
    )
    assert np.all(np.isfinite(x))
    assert len(stats) == 4
    viol_eq = np.abs(lp2.a_equalities.tocsr() @ x - lp2.b_equalities).max()
    assert viol_eq < 1e-2


def test_sharded_cp_permute_matches(problem):
    lp = problem
    mesh = default_mesh(8)
    common = dict(nb_max_iter=3000, nb_iter_plot=3000, dtype=np.float64)
    args = (lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
            lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
            lp.lower_bounds, lp.upper_bounds, mesh)
    x_p = chambolle_pock_ppd_sharded(*args, permute=True, **common)
    x_n = chambolle_pock_ppd_sharded(*args, permute=False, **common)
    np.testing.assert_allclose(x_p, x_n, atol=1e-6)


def test_sharded_cp_full_state_resume_and_stop_tol(problem):
    """Full-state resume (x0/x30/y duals) and stop_tol parity with the
    single-chip solver on the 8-device mesh."""
    lp = problem
    mesh = default_mesh(8)
    args = (lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
            lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
            lp.lower_bounds, lp.upper_bounds, mesh)
    common = dict(nb_iter_plot=200, dtype=np.float64, permute=False)
    x_full = chambolle_pock_ppd_sharded(*args, nb_max_iter=400, **common)

    # run 200, capture state via the single-chip solver convention: re-run
    # the first 200 on the mesh then resume with the captured duals
    from pysparselp_tpu.parallel.sharded_cp import build_sharded_cp_data, \
        sharded_cp_chunk
    from pysparselp_tpu.solvers.chambolle_pock import _fold_one_sided

    a_one, b_ineq = _fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower,
                                    lp.b_upper)
    data, state = build_sharded_cp_data(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities, a_one,
        b_ineq, lp.lower_bounds, lp.upper_bounds, mesh, dtype=np.float64)
    state, _ = sharded_cp_chunk(data, state, mesh, 200)
    m_e = lp.a_equalities.shape[0]
    m_i = a_one.shape[0]
    x_res = chambolle_pock_ppd_sharded(
        *args, nb_max_iter=200, x0=np.asarray(state["x"]),
        x30=np.asarray(state["x3"]),
        y_eq0=np.asarray(state["y_eq"]).reshape(-1)[:m_e],
        y_ineq0=np.asarray(state["y_ineq"]).reshape(-1)[:m_i], **common)
    np.testing.assert_allclose(x_res, x_full, atol=1e-10)

    # stop_tol terminates early (loose tolerance: the point is the plumbing)
    lp.solve(method="chambolle_pock_ppd", mesh=mesh, nb_iter=8000,
             nb_iter_plot=400, stop_tol=5e-2)
    assert lp.itrn_curve[-1] < 8000


def test_sharded_cp_dia_align_matches_unpermuted():
    """The anchor-aligned + per-shard-DIA multi-chip layout (the grid-LP
    flagship path) produces the same solution as the unpermuted tile
    layout on the 8-device mesh."""
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(16, 0.5, 500)
    a = lp.a_inequalities.tocsr()
    args = (lp.costsvector, None, None, a, lp.b_lower, lp.b_upper,
            lp.lower_bounds, lp.upper_bounds, default_mesh(8))
    common = dict(nb_max_iter=600, nb_iter_plot=300, dtype=np.float64)
    x_tiles = chambolle_pock_ppd_sharded(*args, permute=False, **common)
    x_dia = chambolle_pock_ppd_sharded(*args, permute="align", **common)
    np.testing.assert_allclose(x_dia, x_tiles, atol=1e-9)


def test_sharded_cp_dia_align_device_count_invariance():
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(16, 0.5, 500)
    a = lp.a_inequalities.tocsr()

    def run(ndev):
        return chambolle_pock_ppd_sharded(
            lp.costsvector, None, None, a, lp.b_lower, lp.b_upper,
            lp.lower_bounds, lp.upper_bounds, default_mesh(ndev),
            permute="align", nb_max_iter=300, nb_iter_plot=300,
            dtype=np.float64)

    np.testing.assert_allclose(run(8), run(2), atol=1e-9)


def test_sharded_cp_dia_align_with_equalities():
    """Align + per-shard DIA with BOTH constraint systems present."""
    rng = np.random.RandomState(5)
    n = 60
    import scipy.sparse

    a_eq = scipy.sparse.random(10, n, density=0.15, random_state=rng,
                               format="csr")
    a_in = scipy.sparse.random(40, n, density=0.12, random_state=rng,
                               format="csr")
    x_feas = rng.rand(n)
    beq = a_eq @ x_feas
    bu = a_in @ x_feas + 0.5
    c = rng.randn(n)
    args = (c, a_eq, beq, a_in, None, bu, np.zeros(n), np.ones(n),
            default_mesh(8))
    common = dict(nb_max_iter=400, nb_iter_plot=200, dtype=np.float64)
    x_tiles = chambolle_pock_ppd_sharded(*args, permute=False, **common)
    x_dia = chambolle_pock_ppd_sharded(*args, permute="align", **common)
    np.testing.assert_allclose(x_dia, x_tiles, atol=1e-9)


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", [(90, 70), (64, 200), (300, 40)])
def test_sharded_dia_operator_matches_scipy(shape, ndev):
    """Per-shard DIA planes with runtime offsets: the shard-local forward
    products stack to ``A x`` and the window products sum (the psum) to
    ``Aᵀ y``, for uneven shard heights and offsets beyond a shard."""
    import scipy.sparse

    from pysparselp_tpu.parallel.sharded_dia import (build_system_dia,
                                                     local_matvec_dia,
                                                     local_rmatvec_dia)

    m, n = shape
    rng = np.random.RandomState(m + n + ndev)
    offs = (-m // 3, -2, 0, 1, 7, n // 2)
    a = scipy.sparse.diags([rng.randn(min(m, n)) for _ in offs], offs,
                           shape=(m, n)).tocsr()
    data, rows_loc, m_pad = build_system_dia(a, np.zeros(m), ndev)
    assert m_pad == rows_loc * ndev >= m
    x = rng.randn(n)
    y = np.concatenate([rng.randn(m), np.zeros(m_pad - m)])
    fwd, back = [], np.zeros(n)
    for d in range(ndev):
        sys_l = {k: jax.numpy.asarray(v[d]) for k, v in data.items()}
        fwd.append(np.asarray(local_matvec_dia(sys_l, jax.numpy.asarray(x),
                                               n)))
        y_l = jax.numpy.asarray(y[d * rows_loc:(d + 1) * rows_loc])
        back += np.asarray(local_rmatvec_dia(sys_l, y_l, n))
    np.testing.assert_allclose(np.concatenate(fwd)[:m], a @ x, atol=1e-12)
    np.testing.assert_allclose(back, a.T @ y[:m], atol=1e-12)


def test_sharded_dia_solve_matches_single_device():
    """lp.solve(mesh=...) with the aligned layout runs per-shard DIA over
    the 8-device mesh, shards on 8 devices, same trajectory as the
    single-device solve (f64)."""
    from pysparselp_tpu.examples.potts import build_linear_program
    from pysparselp_tpu.parallel import sharded_cp

    lp, _gt, _idx, _ = build_linear_program(12, 0.5, 500)
    kw = dict(method="chambolle_pock_ppd", nb_iter=300, nb_iter_plot=150,
              dtype=np.float64)
    x1, _ = lp.solve(**kw)
    x8, _ = lp.solve(mesh=default_mesh(8), permute="align", **kw)
    plan = sharded_cp.last_plan
    assert plan["operator"] == "dia" and plan["layout"] == "align"
    assert sorted(set(plan["shard_devices"])) == list(range(8))
    np.testing.assert_allclose(x8, x1, atol=1e-9)


def test_sharded_dual_gradient_ascent_matches_single_chip(problem):
    """Row-sharded DGA (2-4 psums/iter, replicated exact line search).

    Short horizon: exact trajectory match (pins the sharded math — the
    psum reductions reproduce the single-chip reduced costs/directions).
    Long horizon: equal-quality bar only, because the exact line search's
    breakpoint sort is razor-edge discontinuous — a last-ulp difference
    from reduction reassociation eventually flips one breakpoint and the
    (equally valid) ascent paths diverge."""
    lp = problem
    mesh = default_mesh(8)
    for it in (1, 2):
        lp.solve(method="dual_gradient_ascent", nb_iter=it,
                 nb_iter_plot=it)
        e1 = lp.dobj_curve[-1]
        lp.solve(method="dual_gradient_ascent", nb_iter=it,
                 nb_iter_plot=it, mesh=mesh)
        e8 = lp.dobj_curve[-1]
        np.testing.assert_allclose(e8, e1, rtol=1e-12)

    ref = lp.solve(method="scipy_simplex", get_timing=False)
    opt = float(lp.costsvector @ ref)
    lp.solve(method="dual_gradient_ascent", nb_iter=2000,
             nb_iter_plot=2000)
    e1 = lp.dobj_curve[-1]
    lp.solve(method="dual_gradient_ascent", nb_iter=2000,
             nb_iter_plot=2000, mesh=mesh)
    e8 = lp.dobj_curve[-1]
    # both dual bounds sit below the optimum, at comparable quality
    assert e1 <= opt + 1e-9 and e8 <= opt + 1e-9
    assert abs(e8 - e1) < 0.15 * (1 + abs(opt) - min(e1, e8))


def test_sharded_dca_matches_single_chip_blocked(problem):
    """Mesh-distributed blocked DCA: same tie draws as the single-chip
    blocked sweep (true-size tie vectors sliced per shard), so the
    trajectories coincide up to psum reassociation."""
    lp = problem
    x1, _ = lp.solve(method="dual_coordinate_ascent", nb_iter=8,
                     nb_iter_plot=1, mode="blocked")
    x8, _ = lp.solve(method="dual_coordinate_ascent", nb_iter=8,
                     nb_iter_plot=1, mesh=default_mesh(8))
    np.testing.assert_allclose(x8, x1, atol=1e-8)


@pytest.mark.parametrize("ndev", [1, 4])
def test_sharded_dca_device_count_invariance(problem, ndev):
    lp = problem
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    x_n, _ = lp.solve(method="dual_coordinate_ascent", nb_iter=6,
                      nb_iter_plot=1, mesh=mesh)
    x_8, _ = lp.solve(method="dual_coordinate_ascent", nb_iter=6,
                      nb_iter_plot=1, mesh=default_mesh(8))
    np.testing.assert_allclose(x_n, x_8, atol=1e-8)
