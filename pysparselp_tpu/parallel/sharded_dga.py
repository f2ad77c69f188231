"""Row-sharded dual gradient ascent over a device mesh.

Multi-chip realization of :func:`~pysparselp_tpu.solvers.dual_ascent.
dual_gradient_ascent` (reference ``pysparselp/DualGradientAscent.py:68-245``)
on the same row partition as the sharded CP solver — duals and constraint
rows live with their shards, the primal data is replicated:

* the reduced costs ``c̄ = c + Σ_d A_dᵀ y_d`` and the line-search direction
  ``gᵀA`` are each one ``psum`` of an n-vector;
* the dual gradients ``g = A x − b`` are purely local (x replicated);
* the exact breakpoint line search (sort + cumsum over the PRIMAL
  dimension) runs replicated on every device — identical inputs, identical
  step, no collective;
* the y≥0 max-step clamp reduces with ``pmin``; scalars (``gᵀb``, the tie
  RNG) are replicated.

Per iteration: at most four n-vector ``psum``s (reduced costs + direction,
once per constraint system) — the line searches are latency, not traffic.
Data layout is shared with the CP solver
(:func:`~pysparselp_tpu.parallel.sharded_cp.build_sharded_cp_data`).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.linesearch import exact_dual_line_search
from ..solvers.dual_ascent import _dual_energy, _optim_x, _safe_mid
from .sharded_cp import (_data_state_specs, _local_matvec, _local_rmatvec,
                         _make_ctx, build_sharded_cp_data)


@functools.partial(jax.jit, static_argnames=("mesh", "nsteps"))
def sharded_dga_chunk(data, state, mesh: Mesh, nsteps: int):
    """Run ``nsteps`` row-sharded dual-ascent iterations."""
    axis = mesh.axis_names[0]
    has_eq = "eq" in data
    has_ineq = "ineq" in data
    in_specs_data, _ = _data_state_specs(data, axis, has_eq, has_ineq)
    y_specs = {}
    if has_eq:
        y_specs["y_eq"] = P(axis)
    if has_ineq:
        y_specs["y_ineq"] = P(axis)
    state_specs = (dict(y_specs), P())
    out_specs = (
        state_specs,
        {"x": P(), "energy": P(), "primal": P(),
         "max_violated_equality": P(), "max_violated_inequality": P()},
    )

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(in_specs_data, state_specs),
        out_specs=out_specs, check_vma=False,
    )
    def run(d, s):
        ctx = _make_ctx(d, axis, has_eq, has_ineq)
        c, lb, ub = ctx["c"], ctx["lb"], ctx["ub"]
        eq_l, in_l = ctx["eq_l"], ctx["in_l"]
        n = c.shape[0]
        mid = _safe_mid(lb, ub)
        ys, key0 = s

        def c_bar_of(y_eq, y_in):
            part = jnp.zeros_like(c)
            if eq_l is not None:
                part = part + _local_rmatvec(eq_l, y_eq, n)
            if in_l is not None:
                part = part + _local_rmatvec(in_l, y_in, n)
            return c + jax.lax.psum(part, axis)

        def one_iter(carry, _):
            y_eq, y_in, key = carry
            c_bar = c_bar_of(y_eq, y_in)
            x = _optim_x(c_bar, lb, ub, mid)

            if in_l is not None:
                g = _local_matvec(in_l, x, n) - in_l["b"]
                g = jnp.where(y_in <= 0, jnp.maximum(g, 0.0), g)
                has_neg = jax.lax.pmax(
                    jnp.any(g < 0).astype(c.dtype), axis) > 0
                key, sub = jax.random.split(key)
                tie_t = jax.random.uniform(sub, dtype=c.dtype)
                da = jax.lax.psum(_local_rmatvec(in_l, g, n), axis)
                db = jax.lax.psum(jnp.dot(g, in_l["b"]), axis)
                coef = exact_dual_line_search(da, db, c_bar, ub, lb, tie_t)
                maxstep = jax.lax.pmin(jnp.min(
                    jnp.where(g < 0, y_in / jnp.maximum(-g, 1e-300),
                              jnp.inf)), axis)
                coef = jnp.minimum(jnp.maximum(coef, 0.0), maxstep)
                y_in = jnp.where(
                    has_neg, jnp.maximum(y_in + coef * g, 0.0), y_in)
                c_bar = c_bar_of(y_eq, y_in)
                x = _optim_x(c_bar, lb, ub, mid)

            if eq_l is not None:
                g_eq = _local_matvec(eq_l, x, n) - eq_l["b"]
                any_g = jax.lax.pmax(
                    jnp.any(g_eq != 0).astype(c.dtype), axis) > 0
                key, sub = jax.random.split(key)
                tie_t = jax.random.uniform(sub, dtype=c.dtype)
                da = jax.lax.psum(_local_rmatvec(eq_l, g_eq, n), axis)
                db = jax.lax.psum(jnp.dot(g_eq, eq_l["b"]), axis)
                coef_eq = exact_dual_line_search(da, db, c_bar, ub, lb,
                                                 tie_t)
                coef_eq = jnp.where(jnp.isfinite(coef_eq), coef_eq, 0.0)
                y_eq = jnp.where(
                    any_g, y_eq + jnp.maximum(coef_eq, 0.0) * g_eq, y_eq)

            return (y_eq, y_in, key), None

        dt = c.dtype
        y_eq0 = ys["y_eq"][0] if has_eq else jnp.zeros((0,), dt)
        y_in0 = ys["y_ineq"][0] if has_ineq else jnp.zeros((0,), dt)
        (y_eq, y_in, key), _ = jax.lax.scan(
            one_iter, (y_eq0, y_in0, key0), None, length=nsteps)

        c_bar = c_bar_of(y_eq, y_in)
        lin = jnp.asarray(0.0, dt)
        if eq_l is not None:
            lin = lin - jax.lax.psum(jnp.dot(y_eq, eq_l["b"]), axis)
        if in_l is not None:
            lin = lin - jax.lax.psum(jnp.dot(y_in, in_l["b"]), axis)
        x = _optim_x(c_bar, lb, ub, mid)
        energy = _dual_energy(c_bar, lb, ub, lin)
        max_v_eq = jnp.asarray(0.0, dt)
        max_v_ineq = jnp.asarray(0.0, dt)
        if eq_l is not None:
            r = jnp.abs(_local_matvec(eq_l, x, n)
                        - eq_l["b"]) * eq_l["row_mask"]
            max_v_eq = jax.lax.pmax(jnp.max(r), axis)
        if in_l is not None:
            r = _local_matvec(in_l, x, n) - in_l["b"]
            r = jnp.where(in_l["row_mask"] > 0, r, -jnp.inf)
            max_v_ineq = jax.lax.pmax(jnp.max(r), axis)

        out_state = {}
        if has_eq:
            out_state["y_eq"] = y_eq[None, :]
        if has_ineq:
            out_state["y_ineq"] = y_in[None, :]
        metrics = {
            "x": x, "energy": energy, "primal": jnp.dot(c, x),
            "max_violated_equality": max_v_eq,
            "max_violated_inequality": max_v_ineq,
        }
        return (out_state, key), metrics

    return run(data, state)


def dual_gradient_ascent_sharded(
    x, lp, mesh, nb_max_iter=1000, callback_func=None, y_eq=None,
    y_ineq=None, max_time=None, nb_iter_plot=1, dtype=None,
    start_time=None, seed=0, stop_tol=None,
):
    """Mesh-parallel dual gradient ascent; same contract as the single-chip
    solver (returns ``(x, y_eq, y_ineq)``)."""
    from ..problem import default_dtype
    from ..solvers.base import (HostLoop, ToleranceStop, chunk_schedule,
                                emit_callback, to_np)

    del x
    dtype = dtype or default_dtype()
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    if lp.b_lower is not None and np.asarray(lp.b_lower).size:
        assert np.max(lp.b_lower) == -np.inf, (
            "dual_gradient_ascent needs a one-sided inequality system"
        )
    rng = np.random.RandomState(seed)
    a_eq = (lp.a_equalities.tocsr()
            if lp.a_equalities is not None and lp.a_equalities.shape[0]
            else None)
    a_in = (lp.a_inequalities.tocsr()
            if lp.a_inequalities is not None and lp.a_inequalities.shape[0]
            else None)
    m_eq = a_eq.shape[0] if a_eq is not None else 0
    m_in = a_in.shape[0] if a_in is not None else 0
    # random dual init matching the single-chip solver's draw order
    y_eq0 = -rng.rand(m_eq) if y_eq is None else np.asarray(y_eq)
    y_in0 = np.abs(rng.rand(m_in)) if y_ineq is None else np.asarray(y_ineq)

    data, cp_state = build_sharded_cp_data(
        np.asarray(lp.costsvector, np.float64), a_eq,
        lp.b_equalities if a_eq is not None else None, a_in,
        lp.b_upper if a_in is not None else None,
        np.asarray(lp.lower_bounds, np.float64),
        np.asarray(lp.upper_bounds, np.float64), mesh,
        dtype=np_dtype, y_eq0=y_eq0 if m_eq else None,
        y_ineq0=y_in0 if m_in else None,
    )
    ys = {k: v for k, v in cp_state.items() if k in ("y_eq", "y_ineq")}
    state = (ys, jax.random.PRNGKey(seed))

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    x_out = np.zeros(lp.nb_variables)
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        state, metrics = sharded_dga_chunk(data, state, mesh, nsteps)
        niter += nsteps
        x_out = metrics["x"]
        emit_callback(
            callback_func, niter, x_out,
            metrics["primal"], metrics["energy"], lambda: loop.elapsed,
            metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        )
        if loop.timed_out or tstop.check(
            metrics["energy"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    ys = state[0]

    def y_host(name, m):
        if name not in ys:
            return np.zeros(0)
        return np.asarray(ys[name], np.float64).reshape(-1)[:m]

    return to_np(x_out), y_host("y_eq", m_eq), y_host("y_ineq", m_in)
