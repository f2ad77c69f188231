"""Dual gradient ascent and dual coordinate ascent LP solvers in JAX.

* ``dual_gradient_ascent`` — full-gradient ascent on the LP dual with exact
  line search along the gradient (reference
  ``pysparselp/DualGradientAscent.py:68-245``).  One iteration is two
  transpose-SpMVs, two SpMVs, and two sort+cumsum exact line searches —
  entirely VPU-parallel, compiled as one fused chunk.

* ``dual_coordinate_ascent`` — exact per-constraint coordinate maximization
  (reference ``pysparselp/DualCoordinateAscent.py:39-367``, after the airline
  crew-scheduling method of Wedelin, generalized to arbitrary A and bounds).
  The per-row sweeps are inherently sequential through the reduced costs
  ``c̄``; they are compiled as ``lax.fori_loop``s whose body does an
  O(K log K) breakpoint search on the row's ELL slice — faithful to the
  reference semantics while keeping the whole sweep on device (no per-row
  host round-trips).  Greedy integer rounding hooks in on the host between
  sweeps, exactly where the reference calls it
  (``DualCoordinateAscent.py:287-294``).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ..ops.linesearch import exact_dual_line_search
from ..problem import EllMatrix, default_dtype, ell_from_scipy
from .base import (HostLoop, ToleranceStop, chunk_schedule,
                   emit_callback, to_np)


# ----------------------------------------------------------------------
# shared dual-LP pieces
# ----------------------------------------------------------------------


def _optim_x(c_bar, lb, ub, tie_mid):
    """Primal minimizer of the Lagrangian at fixed duals
    (``DualGradientAscent.py:106-119``): lb where c̄>0, ub where c̄<0,
    ``tie_mid`` where c̄==0."""
    return jnp.where(c_bar > 0, lb, jnp.where(c_bar < 0, ub, tie_mid))


def _safe_mid(lb, ub):
    """0.5(lb+ub) with inf-aware fallbacks (``DualCoordinateAscent.py:104-117``)."""
    mid = 0.5 * (lb + ub)
    mid = jnp.where(jnp.isinf(lb) & ~jnp.isinf(ub), ub, mid)
    mid = jnp.where(~jnp.isinf(lb) & jnp.isinf(ub), lb, mid)
    mid = jnp.where(jnp.isinf(lb) & jnp.isinf(ub), 0.0, mid)
    return mid


def _dual_energy(c_bar, lb, ub, lin_term):
    """Dual objective: Σ_k min(c̄_k l_k, c̄_k u_k) − yᵀb  (``DualGradientAscent.py:121-133``)."""
    contrib = jnp.where(
        c_bar > 0, c_bar * lb, jnp.where(c_bar < 0, c_bar * ub, 0.0)
    )
    return jnp.sum(contrib) + lin_term


# ----------------------------------------------------------------------
# dual gradient ascent
# ----------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("nsteps",))
def _dga_chunk(data, state, nsteps: int):
    c, lb, ub = data["c"], data["lb"], data["ub"]
    a_eq, b_eq = data.get("a_eq"), data.get("b_eq")
    a_in, b_in = data.get("a_ineq"), data.get("b_upper")
    mid = _safe_mid(lb, ub)

    def one_iter(carry, _):
        y_eq, y_ineq, key = carry
        c_bar = c
        if a_eq is not None:
            c_bar = c_bar + a_eq.rmatvec(y_eq)
        if a_in is not None:
            c_bar = c_bar + a_in.rmatvec(y_ineq)
        x = _optim_x(c_bar, lb, ub, mid)

        if a_in is not None:
            g = a_in.matvec(x) - b_in
            g = jnp.where(y_ineq <= 0, jnp.maximum(g, 0.0), g)
            has_neg = jnp.any(g < 0)
            key, sub = jax.random.split(key)
            tie_t = jax.random.uniform(sub, dtype=c.dtype)
            coef = exact_dual_line_search(
                a_in.rmatvec(g), jnp.dot(g, b_in), c_bar, ub, lb, tie_t
            )
            maxstep = jnp.min(
                jnp.where(g < 0, y_ineq / jnp.maximum(-g, 1e-300), jnp.inf)
            )
            coef = jnp.minimum(jnp.maximum(coef, 0.0), maxstep)
            y_ineq = jnp.where(
                has_neg, jnp.maximum(y_ineq + coef * g, 0.0), y_ineq
            )
            # refresh reduced costs after the inequality step
            c_bar = c + a_in.rmatvec(y_ineq)
            if a_eq is not None:
                c_bar = c_bar + a_eq.rmatvec(y_eq)
            x = _optim_x(c_bar, lb, ub, mid)

        if a_eq is not None:
            g_eq = a_eq.matvec(x) - b_eq
            any_g = jnp.any(g_eq != 0)
            key, sub = jax.random.split(key)
            tie_t = jax.random.uniform(sub, dtype=c.dtype)
            coef_eq = exact_dual_line_search(
                a_eq.rmatvec(g_eq), jnp.dot(g_eq, b_eq), c_bar, ub, lb, tie_t
            )
            coef_eq = jnp.where(jnp.isfinite(coef_eq), coef_eq, 0.0)
            y_eq = jnp.where(any_g, y_eq + jnp.maximum(coef_eq, 0.0) * g_eq, y_eq)

        return (y_eq, y_ineq, key), None

    state, _ = jax.lax.scan(one_iter, state, None, length=nsteps)
    y_eq, y_ineq, key = state

    c_bar = c
    lin = jnp.asarray(0.0, c.dtype)
    if a_eq is not None:
        c_bar = c_bar + a_eq.rmatvec(y_eq)
        lin = lin - jnp.dot(y_eq, b_eq)
    if a_in is not None:
        c_bar = c_bar + a_in.rmatvec(y_ineq)
        lin = lin - jnp.dot(y_ineq, b_in)
    x = _optim_x(c_bar, lb, ub, _safe_mid(lb, ub))
    energy = _dual_energy(c_bar, lb, ub, lin)
    max_v_eq = (
        jnp.max(jnp.abs(a_eq.matvec(x) - b_eq)) if a_eq is not None else 0.0
    )
    max_v_ineq = (
        jnp.max(a_in.matvec(x) - b_in) if a_in is not None else 0.0
    )
    metrics = dict(
        x=x,
        energy=energy,
        primal=jnp.dot(c, x),
        max_violated_equality=max_v_eq,
        max_violated_inequality=max_v_ineq,
    )
    return state, metrics


def dual_gradient_ascent(
    x,
    lp,
    nb_max_iter=1000,
    callback_func=None,
    y_eq=None,
    y_ineq=None,
    max_time=None,
    nb_iter_plot=1,
    dtype=None,
    start_time=None,
    seed=0,
    stop_tol=None,
):
    """Gradient ascent in the dual with exact line search; returns ``(x, y_eq, y_ineq)``.

    Signature parity with ``pysparselp/DualGradientAscent.py:68``.
    """
    dtype = dtype or default_dtype()
    if lp.b_lower is not None and np.asarray(lp.b_lower).size:
        assert np.max(lp.b_lower) == -np.inf, (
            "dual_gradient_ascent needs a one-sided inequality system"
        )

    data = dict(
        c=jnp.asarray(lp.costsvector, dtype),
        lb=jnp.asarray(lp.lower_bounds, dtype),
        ub=jnp.asarray(lp.upper_bounds, dtype),
    )
    rng = np.random.RandomState(seed)
    m_eq = lp.a_equalities.shape[0] if lp.a_equalities is not None else 0
    m_in = lp.a_inequalities.shape[0] if lp.a_inequalities is not None else 0
    if m_eq:
        data["a_eq"] = ell_from_scipy(lp.a_equalities.tocsr(), dtype=dtype)
        data["b_eq"] = jnp.asarray(lp.b_equalities, dtype)
    if m_in:
        data["a_ineq"] = ell_from_scipy(lp.a_inequalities.tocsr(), dtype=dtype)
        data["b_upper"] = jnp.asarray(lp.b_upper, dtype)

    # random dual init, matching the reference's choice (DualGradientAscent.py:92-101)
    y_eq0 = (
        jnp.asarray(-rng.rand(m_eq), dtype)
        if y_eq is None
        else jnp.asarray(y_eq, dtype)
    )
    y_in0 = (
        jnp.asarray(np.abs(rng.rand(m_in)), dtype)
        if y_ineq is None
        else jnp.asarray(y_ineq, dtype)
    )
    state = (y_eq0, y_in0, jax.random.PRNGKey(seed))

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    x_out = np.zeros(lp.nb_variables)
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        state, metrics = _dga_chunk(data, state, nsteps)
        niter += nsteps
        x_out = metrics["x"]
        emit_callback(
            callback_func, niter, x_out,
            metrics["primal"], metrics["energy"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
        )
        if loop.timed_out or tstop.check(
            metrics["energy"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    return to_np(x_out), to_np(state[0]), to_np(state[1])


# ----------------------------------------------------------------------
# dual coordinate ascent
# ----------------------------------------------------------------------


def _row_line_search(vals, cols, b_i, c_bar, lb, ub, tie_t):
    """Exact 1-D dual maximization for one constraint row stored as an ELL
    slice (``DualCoordinateAscent.py:139-165``); padding has vals == 0."""
    return exact_dual_line_search(
        vals, b_i, jnp.take(c_bar, cols), jnp.take(ub, cols), jnp.take(lb, cols), tie_t
    )


def _color_rows(csr):
    """Greedy graph coloring of constraint rows by shared columns.

    Rows with pairwise-disjoint column support get the same color and can
    take their exact coordinate steps simultaneously (the step of row i only
    reads/writes c̄ on i's own columns).  Returns a list of row-index arrays,
    one per color.  Colors ≈ max column degree, so on large structured LPs
    a sweep shrinks from m sequential steps to a handful of batched ones.
    """
    csr = scipy.sparse.csr_matrix(csr)
    m, n = csr.shape
    indptr, indices = csr.indptr, csr.indices
    cnt = np.diff(indptr)
    row_of = np.repeat(np.arange(m), cnt)
    # vectorized maximal-independent-set coloring (O(colors * nnz) numpy;
    # a per-row python loop here cost minutes at the million-row scales
    # this mode exists for).  Per color: every column is claimed by the
    # smallest candidate row touching it, rows winning ALL their columns
    # join the color (pairwise disjoint by construction), and the inner
    # loop repeats on the still-compatible rows until the color is a
    # MAXIMAL independent set — without the saturation pass the group
    # count balloons ~6x (Potts-30: 62 colors instead of 10).
    remaining = np.ones(m, bool)
    groups = []
    while remaining.any():
        col_taken = np.zeros(n, bool)
        in_color = np.zeros(m, bool)
        cand = remaining.copy()
        while cand.any():
            keep = cand[row_of]
            claim = np.full(n, m, np.int64)
            np.minimum.at(claim, indices[keep], row_of[keep])
            wins = np.ones(m, bool)
            np.logical_and.at(wins, row_of[keep],
                              claim[indices[keep]] == row_of[keep])
            sel = cand & wins
            if not sel.any():
                break
            in_color |= sel
            col_taken[indices[sel[row_of]]] = True
            blocked = np.zeros(m, bool)
            np.logical_or.at(blocked, row_of, col_taken[indices])
            cand = remaining & ~in_color & ~blocked
        groups.append(np.nonzero(in_color)[0])
        remaining &= ~in_color
    return groups


def _dca_color_sweep(a_vals, a_cols, b, active, y, c_bar, lb, ub, key,
                     groups, project):
    """Blocked sweep: one batched exact line search per color group.

    Within a group the rows' supports are disjoint, so the simultaneous
    steps equal the sequential ones; groups chain through c̄ like the
    sequential sweep chains through rows.  ``project`` clamps y >= 0
    (inequality duals).
    """
    # the lambda reads ``c_bar`` from this scope at call time, so each color
    # group sees the reduced costs updated by the previous groups
    batched_search = jax.vmap(
        lambda v, cl, bi, t: exact_dual_line_search(
            v, bi, jnp.take(c_bar, cl), jnp.take(ub, cl),
            jnp.take(lb, cl), t
        ),
    )
    for rows in groups:
        key, sub = jax.random.split(key)
        tie = jax.random.uniform(sub, (rows.shape[0],), dtype=c_bar.dtype)
        v = jnp.take(a_vals, rows, axis=0)
        cl = jnp.take(a_cols, rows, axis=0)
        alpha = batched_search(v, cl, jnp.take(b, rows), tie)
        alpha = jnp.where(
            jnp.take(active, rows) & jnp.isfinite(alpha), alpha, 0.0
        )
        if project:
            y_new = jnp.maximum(jnp.take(y, rows) + alpha, 0.0)
            diff = y_new - jnp.take(y, rows)
            y = y.at[rows].set(y_new)
        else:
            diff = alpha
            y = y.at[rows].add(alpha)
        c_bar = c_bar.at[cl.reshape(-1)].add((diff[:, None] * v).reshape(-1))
    return y, c_bar, key


@functools.partial(jax.jit, static_argnames=())
def _dca_sweep_eq(a_vals, a_cols, b, active, y, c_bar, lb, ub, key):
    """Sequential sweep over equality rows: exact coordinate step per row."""

    def body(i, carry):
        y, c_bar, key = carry
        vals = a_vals[i]
        cols = a_cols[i]
        key, sub = jax.random.split(key)
        tie_t = jax.random.uniform(sub, dtype=c_bar.dtype)
        alpha = _row_line_search(vals, cols, b[i], c_bar, lb, ub, tie_t)
        alpha = jnp.where(active[i] & jnp.isfinite(alpha), alpha, 0.0)
        y = y.at[i].add(alpha)
        c_bar = c_bar.at[cols].add(alpha * vals)
        return (y, c_bar, key)

    return jax.lax.fori_loop(0, a_vals.shape[0], body, (y, c_bar, key))


@functools.partial(jax.jit, static_argnames=())
def _dca_sweep_ineq(a_vals, a_cols, b, active, y, c_bar, lb, ub, key):
    """Same sweep with the y >= 0 projection (``DualCoordinateAscent.py:261-270``)."""

    def body(i, carry):
        y, c_bar, key = carry
        vals = a_vals[i]
        cols = a_cols[i]
        key, sub = jax.random.split(key)
        tie_t = jax.random.uniform(sub, dtype=c_bar.dtype)
        alpha = _row_line_search(vals, cols, b[i], c_bar, lb, ub, tie_t)
        alpha = jnp.where(active[i] & jnp.isfinite(alpha), alpha, 0.0)
        y_new = jnp.maximum(y[i] + alpha, 0.0)
        diff = y_new - y[i]
        y = y.at[i].set(y_new)
        c_bar = c_bar.at[cols].add(diff * vals)
        return (y, c_bar, key)

    return jax.lax.fori_loop(0, a_vals.shape[0], body, (y, c_bar, key))


@functools.partial(jax.jit, static_argnames=("nsweeps",))
def _dca_chunk(data, y_eq, y_ineq, key, prev_energy, nsweeps: int):
    """Run up to ``nsweeps`` DCA outer iterations in ONE dispatch, exiting
    early on the reference's stop condition (dual stalled AND primal
    feasible, ``DualCoordinateAscent.py:318-330``) evaluated on device.

    Used when ``use_greedy_round=False``: the rounding hook needs host
    logic every sweep, but without it the per-sweep host round-trip is pure
    overhead."""

    def cond(carry):
        i, ye, yi, key, e_prev, done, _m = carry
        return (i < nsweeps) & ~done

    def body(carry):
        i, ye, yi, key, e_prev, _done, _m = carry
        ye, yi, key, m = _dca_outer_impl(data, ye, yi, key)
        stalled = m["energy"] < e_prev + 1e-10
        feas = (m["max_violated_inequality"] <= 0) & (
            m["max_violated_equality"] == 0
        )
        return (i + 1, ye, yi, key, m["energy"], stalled & feas, m)

    # prime with one sweep so the carried metrics pytree has a fixed shape
    ye, yi, key, m = _dca_outer_impl(data, y_eq, y_ineq, key)
    stalled = m["energy"] < prev_energy + 1e-10
    feas = (m["max_violated_inequality"] <= 0) & (
        m["max_violated_equality"] == 0
    )
    carry = (jnp.asarray(1), ye, yi, key, m["energy"], stalled & feas, m)
    i, ye, yi, key, _e, done, m = jax.lax.while_loop(cond, body, carry)
    return ye, yi, key, i, done, m


def _dca_outer(data, y_eq, y_ineq, key):
    return jax.jit(_dca_outer_impl)(data, y_eq, y_ineq, key)


def _dca_outer_impl(data, y_eq, y_ineq, key):
    """One outer DCA iteration: eq sweep then ineq sweep, on device."""
    c, lb, ub = data["c"], data["lb"], data["ub"]
    a_eq, b_eq = data.get("a_eq"), data.get("b_eq")
    a_in, b_in = data.get("a_ineq"), data.get("b_upper")
    mid = _safe_mid(lb, ub)

    c_bar = c
    if a_eq is not None:
        c_bar = c_bar + a_eq.rmatvec(y_eq)
    if a_in is not None:
        c_bar = c_bar + a_in.rmatvec(y_ineq)

    if a_eq is not None:
        key, sub = jax.random.split(key)
        tie = jax.random.uniform(sub, lb.shape, dtype=c.dtype)
        x = _optim_x(c_bar, lb, ub, lb + tie * jnp.clip(ub - lb, 0, 1e30))
        active = (a_eq.matvec(x) - b_eq) != 0
        if "eq_groups" in data:
            y_eq, c_bar, key = _dca_color_sweep(
                a_eq.vals, a_eq.cols, b_eq, active, y_eq, c_bar, lb, ub,
                key, data["eq_groups"], project=False,
            )
        else:
            y_eq, c_bar, key = _dca_sweep_eq(
                a_eq.vals, a_eq.cols, b_eq, active, y_eq, c_bar, lb, ub, key
            )
        # rebuild c_bar exactly to avoid incremental drift
        c_bar = c + a_eq.rmatvec(y_eq)
        if a_in is not None:
            c_bar = c_bar + a_in.rmatvec(y_ineq)

    if a_in is not None:
        key, sub = jax.random.split(key)
        tie = jax.random.uniform(sub, lb.shape, dtype=c.dtype)
        x = _optim_x(c_bar, lb, ub, lb + tie * jnp.clip(ub - lb, 0, 1e30))
        g = a_in.matvec(x) - b_in
        g = jnp.where(y_ineq <= 0, jnp.maximum(g, 0.0), g)
        active = g != 0
        if "ineq_groups" in data:
            y_ineq, c_bar, key = _dca_color_sweep(
                a_in.vals, a_in.cols, b_in, active, y_ineq, c_bar, lb, ub,
                key, data["ineq_groups"], project=True,
            )
        else:
            y_ineq, c_bar, key = _dca_sweep_ineq(
                a_in.vals, a_in.cols, b_in, active, y_ineq, c_bar, lb, ub, key
            )
        c_bar = c + a_in.rmatvec(y_ineq)
        if a_eq is not None:
            c_bar = c_bar + a_eq.rmatvec(y_eq)

    # final primal guess with centered ties + cost-sign nudge
    # (``DualCoordinateAscent.py:281-286``)
    x = _optim_x(c_bar, lb, ub, mid)
    x = jnp.where(
        c_bar == 0, mid + 0.1 * jnp.sign(c), x
    )
    lin = jnp.asarray(0.0, c.dtype)
    if a_eq is not None:
        lin = lin - jnp.dot(y_eq, b_eq)
    if a_in is not None:
        lin = lin - jnp.dot(y_ineq, b_in)
    energy = _dual_energy(c_bar, lb, ub, lin)
    max_v_eq = (
        jnp.max(jnp.abs(a_eq.matvec(x) - b_eq)) if a_eq is not None else 0.0
    )
    max_v_ineq = jnp.max(a_in.matvec(x) - b_in) if a_in is not None else 0.0
    metrics = dict(
        x=x, c_bar=c_bar, energy=energy, primal=jnp.dot(c, x),
        max_violated_equality=max_v_eq, max_violated_inequality=max_v_ineq,
    )
    return y_eq, y_ineq, key, metrics


def dual_coordinate_ascent(
    x,
    lp,
    nb_max_iter=20,
    callback_func=None,
    y_eq=None,
    y_ineq=None,
    max_time=None,
    nb_iter_plot=1,
    dtype=None,
    start_time=None,
    seed=1,
    use_greedy_round=True,
    mode="sequential",
):
    """Coordinate ascent in the LP dual; returns ``(x, y_eq, y_ineq)``.

    Signature parity with ``pysparselp/DualCoordinateAscent.py:39``.  On dual
    stall, attempts greedy integer rounding on the host like the reference
    (``DualCoordinateAscent.py:287-294``).

    ``mode`` selects the sweep execution (SURVEY §7.5):

    * ``"sequential"`` (default) — reference-faithful row-at-a-time
      ``fori_loop`` sweeps;
    * ``"blocked"`` — graph-colored parallel sweeps: rows with disjoint
      column support take their exact coordinate steps simultaneously as one
      batched breakpoint search, so a sweep is ~#colors batched steps
      instead of m sequential ones.  Same ascent mathematics (steps within a
      color cannot interact); the trajectory differs only through update
      order and tie randomization.
    """
    import copy as _copy

    dtype = dtype or default_dtype()
    lp2 = _copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()

    data = dict(
        c=jnp.asarray(lp2.costsvector, dtype),
        lb=jnp.asarray(lp2.lower_bounds, dtype),
        ub=jnp.asarray(lp2.upper_bounds, dtype),
    )
    m_eq = lp2.a_equalities.shape[0] if lp2.a_equalities is not None else 0
    m_in = lp2.a_inequalities.shape[0] if lp2.a_inequalities is not None else 0
    if mode not in ("sequential", "blocked"):
        raise ValueError(f"unknown DCA mode {mode!r}")
    if m_eq:
        data["a_eq"] = EllMatrix.from_scipy(lp2.a_equalities.tocsr(), dtype=dtype)
        data["b_eq"] = jnp.asarray(lp2.b_equalities, dtype)
        if mode == "blocked":
            data["eq_groups"] = tuple(
                jnp.asarray(g, jnp.int32)
                for g in _color_rows(lp2.a_equalities.tocsr())
            )
    if m_in:
        data["a_ineq"] = EllMatrix.from_scipy(lp2.a_inequalities.tocsr(), dtype=dtype)
        data["b_upper"] = jnp.asarray(lp2.b_upper, dtype)
        if mode == "blocked":
            data["ineq_groups"] = tuple(
                jnp.asarray(g, jnp.int32)
                for g in _color_rows(lp2.a_inequalities.tocsr())
            )

    y_eq = jnp.zeros(m_eq, dtype) if y_eq is None else jnp.asarray(y_eq, dtype)
    y_ineq = (
        jnp.zeros(m_in, dtype) if y_ineq is None else jnp.asarray(y_ineq, dtype)
    )
    assert float(jnp.min(y_ineq, initial=0.0)) >= 0
    key = jax.random.PRNGKey(seed)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    energy = -np.inf
    x_out = np.zeros(lp2.nb_variables)
    niter = 0
    if not (use_greedy_round and m_in):
        # no per-sweep host hook needed: run whole callback periods in one
        # dispatch with the stall/feasible stop evaluated on device (a
        # per-sweep scalar fetch would otherwise dominate)
        while niter < nb_max_iter:
            nsweeps = max(1, min(nb_iter_plot, nb_max_iter - niter))
            y_eq, y_ineq, key, did, done, metrics = _dca_chunk(
                data, y_eq, y_ineq, key,
                jnp.asarray(energy, dtype), nsweeps)
            niter += int(did)
            energy = float(metrics["energy"])
            x_out = to_np(metrics["x"])
            emit_callback(
                callback_func, niter, x_out,
                float(lp2.costsvector @ x_out), energy,
                lambda: loop.elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
            )
            if bool(done) or loop.timed_out:
                break
        return x_out, to_np(y_eq), to_np(y_ineq)

    while niter < nb_max_iter:
        y_eq, y_ineq, key, metrics = _dca_outer(data, y_eq, y_ineq, key)
        niter += 1
        new_energy = float(metrics["energy"])
        x_out = to_np(metrics["x"])

        stalled = new_energy < energy + 1e-10
        if stalled and use_greedy_round and m_in:
            try:
                from ..integer.rounding import greedy_round

                c_bar = to_np(metrics["c_bar"])
                order = np.argsort(np.abs(x_out - 0.5))
                fixed = c_bar != 0
                xr, valid = greedy_round(
                    x_out, lp2, callback_func=None, maxiter=30,
                    order=order, fixed=fixed,
                )
                if valid:
                    x_out = xr
            except ImportError:
                pass

        if (niter % max(1, nb_iter_plot)) == 0 or niter >= nb_max_iter:
            emit_callback(
                callback_func, niter, x_out,
                float(lp2.costsvector @ x_out), new_energy, lambda: loop.elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
            )
        if loop.timed_out:
            break
        if stalled and float(metrics["max_violated_inequality"]) <= 0 and (
            float(metrics["max_violated_equality"]) == 0
        ):
            break  # primal feasible and dual stalled: done (DualCoordinateAscent.py:318-330)
        energy = new_energy

    return x_out, to_np(y_eq), to_np(y_ineq)
