"""Whole-chunk dense CP kernel (Pallas, Triton route) against the XLA
iteration, in the Pallas interpreter."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pysparselp_tpu import problem as pr
from pysparselp_tpu.ops import cp_dense_triton as kern
from pysparselp_tpu.solvers.chambolle_pock import (
    _cp_chunk_restart_device, _fold_one_sided, _kkt_score, build_cp_problem,
    cp_chunk_impl)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import bench  # noqa: E402


def _dense_problem(me, mi, n, seed):
    rng = np.random.RandomState(seed)
    f32 = jnp.float32
    ae = rng.randn(me, n) * (rng.rand(me, n) < 0.4)
    ai = rng.randn(mi, n) * (rng.rand(mi, n) < 0.4)
    x_feas = rng.rand(n)

    def dense(a):
        return pr.DenseMatrix(a=jnp.asarray(a, f32), nrows=a.shape[0],
                              ncols=n)

    prob = pr.LPProblem(
        c=jnp.asarray(rng.randn(n), f32),
        lb=jnp.zeros(n, f32), ub=jnp.ones(n, f32),
        a_eq=dense(ae) if me else None,
        b_eq=jnp.asarray(ae @ x_feas, f32) if me else None,
        a_ineq=dense(ai) if mi else None, b_lower=None,
        b_upper=jnp.asarray(ai @ x_feas + 0.5, f32) if mi else None,
        n=n, m_eq=me, m_ineq=mi,
    )
    col = jnp.zeros(n, f32)
    pre = dict(theta=jnp.asarray(1.0, f32))
    for op, key in ((prob.a_eq, "sigma_eq"), (prob.a_ineq, "sigma_ineq")):
        if op is not None:
            col = col + op.abs_power_colsum(1.0)
            pre[key] = 1.0 / jnp.maximum(op.abs_power_rowsum(1.0), 1e-9)
    pre["diag_t"] = 1.0 / jnp.maximum(col, 1e-9)
    return prob, pre


def _state(prob):
    x0 = jnp.zeros(prob.n, jnp.float32)
    return (x0, x0, jnp.zeros(prob.m_eq, jnp.float32),
            jnp.zeros(prob.m_ineq, jnp.float32))


def _assert_states_close(got, ref, tol):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=tol, atol=tol)


def test_dense_fused_matches_composed():
    prob, pre = _dense_problem(40, 90, 130, seed=2)
    assert kern.cp_dense_fused_eligible(prob)
    state = _state(prob)
    ref_state, _ = cp_chunk_impl(prob, pre, state, 9)
    fused_state = kern.cp_dense_fused_chunk(prob, pre, state, 9, theta=1.0,
                                            interpret=True)
    _assert_states_close(fused_state, ref_state, 2e-5)


def test_dense_fused_restart_matches_composed():
    prob, pre = _dense_problem(30, 70, 100, seed=8)
    state = _state(prob)
    rstate = {
        "state": state,
        "omega": jnp.asarray(1.0, jnp.float32),
        "mu_restart": _kkt_score(prob, state[0], state[2],
                                 state[3]).astype(jnp.float32),
        "mu_last": jnp.asarray(np.inf, jnp.float32),
        "zx": state[0], "zeq": state[2], "zineq": state[3],
    }
    r_ref, _ = _cp_chunk_restart_device(prob, pre, rstate, 25, 10)
    r_fused, _ = _cp_chunk_restart_device(
        prob, pre, rstate, 25, 10, use_fused="dense", theta_f=1.0,
        interpret=True)
    for k in r_ref:
        a, b = r_ref[k], r_fused[k]
        if isinstance(a, tuple):
            _assert_states_close(b, a, 2e-5)
        else:
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["SC105", "AFIRO", "KB2", "SC50A", "SC50B"])
def test_netlib_kernel_matches_xla_chunk(name):
    """The solver's own lowering of a vendored netlib LP: the kernel and
    the XLA chunk agree after 50 iterations (f32; summation order
    differs)."""
    lp, _gt = bench._netlib_lp(name)
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities is not None else None
    a_in, b_in = _fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower,
                                 lp.b_upper)
    prob, pre = build_cp_problem(lp.costsvector, a_eq, lp.b_equalities,
                                 a_in, b_in, lp.lower_bounds,
                                 lp.upper_bounds, jnp.float32)
    assert kern.cp_dense_fused_eligible(prob), (type(prob.a_eq),
                                                type(prob.a_ineq))
    state = _state(prob)
    ref, _ = cp_chunk_impl(prob, pre, state, 50)
    got = kern.cp_dense_fused_chunk(prob, pre, state, 50, 1.0,
                                    interpret=True)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        err = np.max(np.abs(np.asarray(g) - r), initial=0.0)
        assert err <= 1e-4 * max(1.0, np.max(np.abs(r), initial=0.0)), err


def test_dense_fused_chunks_compose():
    prob, pre = _dense_problem(20, 35, 50, seed=3)
    state = _state(prob)
    s7 = kern.cp_dense_fused_chunk(prob, pre, state, 7, 1.0, interpret=True)
    s3 = kern.cp_dense_fused_chunk(prob, pre, state, 3, 1.0, interpret=True)
    s34 = kern.cp_dense_fused_chunk(prob, pre, s3, 4, 1.0, interpret=True)
    _assert_states_close(s34, s7, 1e-6)


def test_dense_fused_restart_sums():
    """with_sums returns Σ over the chunk of x, y_eq and y_ineq."""
    prob, pre = _dense_problem(12, 20, 30, seed=4)
    state = _state(prob)
    out = kern.cp_dense_fused_call(prob, pre, state[0], state[2], state[3],
                                   6, 1.0, interpret=True, with_sums=True)
    sums = [np.zeros(prob.n), np.zeros(prob.m_eq), np.zeros(prob.m_ineq)]
    s = state
    for _ in range(6):
        s = kern.cp_dense_fused_chunk(prob, pre, s, 1, 1.0, interpret=True)
        for acc, v in zip(sums, (s[0], s[2], s[3])):
            acc += np.asarray(v, np.float64)
    _assert_states_close(out[:4], s, 1e-6)
    for got, ref in zip(out[4:], sums):
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("me,mi,n", [(3, 5, 7), (0, 33, 17), (9, 0, 65),
                                     (64, 64, 128)])
def test_dense_fused_pads_to_powers_of_two(me, mi, n):
    prob, pre = _dense_problem(me, mi, n, seed=me + mi + n)
    n_pad, me_pad, mi_pad = kern.padded_shapes(prob)
    for size, pad in ((n, n_pad), (me, me_pad), (mi, mi_pad)):
        if size:
            assert pad >= size and pad & (pad - 1) == 0 and pad < 2 * size
        else:
            assert pad == 0
    state = _state(prob)
    ref, _ = cp_chunk_impl(prob, pre, state, 5)
    got = kern.cp_dense_fused_chunk(prob, pre, state, 5, 1.0, interpret=True)
    assert [g.shape for g in got] == [r.shape for r in ref]
    _assert_states_close(got, ref, 2e-5)


def test_dense_fused_shape_gate():
    prob, _ = _dense_problem(40, 90, 130, seed=5)
    assert kern.cp_dense_fused_eligible(prob)
    big, _ = _dense_problem(200, 200, 300, seed=5)    # 2 x 256 x 512 padded
    assert not kern.cp_dense_fused_eligible(big)
    f64 = dataclasses.replace(prob, a_eq=pr.DenseMatrix(
        a=prob.a_eq.a.astype(jnp.float64), nrows=40, ncols=130))
    assert not kern.cp_dense_fused_eligible(f64)
    ell = dataclasses.replace(prob, a_ineq=pr.EllMatrix.from_scipy(
        np.asarray(prob.a_ineq.a), dtype=jnp.float32))
    assert not kern.cp_dense_fused_eligible(ell)
    none = dataclasses.replace(prob, a_eq=None, a_ineq=None)
    assert not kern.cp_dense_fused_eligible(none)


def test_dense_fused_refuses_compiled_off_gpu():
    assert jax.default_backend() != "gpu"
    prob, pre = _dense_problem(4, 6, 8, seed=6)
    with pytest.raises(RuntimeError, match="GPU"):
        kern.cp_dense_fused_chunk(prob, pre, _state(prob), 2, 1.0)


def test_solver_keeps_xla_iteration_off_gpu():
    """Off a GPU the solver never picks the kernel (no silent interpreter
    fallback), though the lowered problem is eligible."""
    from pysparselp_tpu.solvers import chambolle_pock as cpm

    lp, _gt = bench._netlib_lp("AFIRO")
    lp.solve(method="chambolle_pock_ppd", nb_iter=20, nb_iter_plot=10,
             dtype=np.float32)
    assert cpm.last_plan["eq"] == "DenseMatrix"
    assert cpm.last_plan["fused"] is None
