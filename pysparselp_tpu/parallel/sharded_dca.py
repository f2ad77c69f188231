"""Row-sharded blocked dual coordinate ascent over a device mesh.

Multi-chip realization of the BLOCKED mode of
:func:`~pysparselp_tpu.solvers.dual_ascent.dual_coordinate_ascent`
(reference ``pysparselp/DualCoordinateAscent.py:39-367``; blocked mode =
graph-colored parallel sweeps, SURVEY §7.5).  The sequential mode is a
chain through every row's reduced-cost update and cannot be distributed;
the colored sweep can: rows within a color have pairwise-disjoint column
support, so

* each color's row batch is SPLIT across the mesh axis; every device runs
  the exact breakpoint line searches for its slice against the replicated
  reduced costs;
* the per-color updates merge with two ``psum``s — the y-delta
  (disjoint-row scatter) and the reduced-cost delta (disjoint-column
  scatter);
* everything between sweeps (active-set computation, c̄ rebuilds, the
  primal guess, metrics) is replicated arithmetic on replicated data —
  no collective.

Communication per outer iteration: 2·#colors psums per constraint
system.  Tie randomization draws one replicated vector per color and
slices it by ``axis_index``, so trajectories are independent of the mesh
size (device-count invariant) up to float reassociation of the psums.
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


def pad_groups(groups, ndev, m):
    """Pad each color's row-id array to an ndev multiple (dummy id = m)
    and reshape to (ndev, rg_loc)."""
    out = []
    for g in groups:
        g = np.asarray(g, np.int32)
        rg_loc = max(-(-g.size // ndev), 1)
        gp = np.full(ndev * rg_loc, m, np.int32)
        gp[:g.size] = g
        out.append(gp.reshape(ndev, rg_loc))
    return tuple(out)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "eq_sizes", "in_sizes"))
def sharded_dca_outer(data, y_eq, y_ineq, key, mesh: Mesh,
                      eq_sizes=(), in_sizes=()):
    """One outer blocked-DCA iteration with the color sweeps distributed
    over the mesh; returns ``(y_eq, y_ineq, key, metrics)``.

    ``eq_sizes``/``in_sizes`` are the TRUE (unpadded) color sizes: tie
    vectors are drawn at those shapes, so the random sequence — and hence
    the trajectory — matches the single-chip blocked sweep and is
    independent of the mesh size."""
    axis = mesh.axis_names[0]
    ndev = int(np.prod(list(mesh.shape.values())))

    in_specs_data = jax.tree.map(lambda _: P(), data)
    for k in ("eq_groups", "ineq_groups"):
        if k in data:
            in_specs_data[k] = jax.tree.map(lambda _: P(axis), data[k])
    metric_specs = {k: P() for k in (
        "x", "c_bar", "energy", "primal", "max_violated_equality",
        "max_violated_inequality")}

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(in_specs_data, P(), P(), P()),
        out_specs=(P(), P(), P(), metric_specs), check_vma=False,
    )
    def run(d, y_eq, y_ineq, key):
        c, lb, ub = d["c"], d["lb"], d["ub"]
        a_eq, b_eq = d.get("a_eq"), d.get("b_eq")
        a_in, b_in = d.get("a_ineq"), d.get("b_upper")
        mid = _safe_mid(lb, ub)
        d_idx = jax.lax.axis_index(axis)

        def color_sweep(ell, b, active, y, c_bar, key, groups, sizes,
                        project):
            m = b.shape[0]

            batched_search = jax.vmap(
                lambda v, cl, bi, t: exact_dual_line_search(
                    v, bi, jnp.take(c_bar, cl), jnp.take(ub, cl),
                    jnp.take(lb, cl), t))

            for rows2d, size in zip(groups, sizes):
                rows = rows2d[0]                      # this shard's slice
                rg_loc = rows.shape[0]
                key, sub = jax.random.split(key)
                # drawn at the TRUE color size (as the single-chip sweep
                # does), zero-padded, then sliced per shard: identical
                # ties per row on any mesh size
                tie_full = jax.random.uniform(sub, (size,),
                                              dtype=c_bar.dtype)
                npad = ndev * rg_loc - size  # rows2d is already sliced
                if npad:
                    tie_full = jnp.concatenate(
                        [tie_full, jnp.zeros((npad,), c_bar.dtype)])
                tie = jax.lax.dynamic_slice(tie_full, (d_idx * rg_loc,),
                                            (rg_loc,))
                valid = rows < m                      # dummy padding ids
                rows_c = jnp.minimum(rows, m - 1)     # clip for gathers
                v = jnp.take(ell.vals, rows_c, axis=0)
                cl = jnp.take(ell.cols, rows_c, axis=0)
                alpha = batched_search(v, cl, jnp.take(b, rows_c), tie)
                alpha = jnp.where(
                    valid & jnp.take(active, rows_c)
                    & jnp.isfinite(alpha), alpha, 0.0)
                if project:
                    y_rows = jnp.take(y, rows_c)
                    diff = jnp.maximum(y_rows + alpha, 0.0) - y_rows
                    diff = jnp.where(valid, diff, 0.0)
                else:
                    diff = alpha
                # rows are disjoint within a color (across shards too):
                # the updates merge as one psum each
                dy = jnp.zeros_like(y).at[rows_c].add(diff)
                y = y + jax.lax.psum(dy, axis)
                dc = jnp.zeros_like(c_bar).at[cl.reshape(-1)].add(
                    (diff[:, None] * v).reshape(-1))
                c_bar = c_bar + jax.lax.psum(dc, axis)
            return y, c_bar, key

        c_bar = c
        if a_eq is not None:
            c_bar = c_bar + a_eq.rmatvec(y_eq)
        if a_in is not None:
            c_bar = c_bar + a_in.rmatvec(y_ineq)

        if a_eq is not None:
            key, sub = jax.random.split(key)
            tie = jax.random.uniform(sub, lb.shape, dtype=c.dtype)
            x = _optim_x(c_bar, lb, ub,
                         lb + tie * jnp.clip(ub - lb, 0, 1e30))
            active = (a_eq.matvec(x) - b_eq) != 0
            y_eq, c_bar, key = color_sweep(
                a_eq, b_eq, active, y_eq, c_bar, key, d["eq_groups"],
                eq_sizes, project=False)
            c_bar = c + a_eq.rmatvec(y_eq)
            if a_in is not None:
                c_bar = c_bar + a_in.rmatvec(y_ineq)

        if a_in is not None:
            key, sub = jax.random.split(key)
            tie = jax.random.uniform(sub, lb.shape, dtype=c.dtype)
            x = _optim_x(c_bar, lb, ub,
                         lb + tie * jnp.clip(ub - lb, 0, 1e30))
            g = a_in.matvec(x) - b_in
            g = jnp.where(y_ineq <= 0, jnp.maximum(g, 0.0), g)
            active = g != 0
            y_ineq, c_bar, key = color_sweep(
                a_in, b_in, active, y_ineq, c_bar, key, d["ineq_groups"],
                in_sizes, project=True)
            c_bar = c + a_in.rmatvec(y_ineq)
            if a_eq is not None:
                c_bar = c_bar + a_eq.rmatvec(y_eq)

        x = _optim_x(c_bar, lb, ub, mid)
        x = jnp.where(c_bar == 0, mid + 0.1 * jnp.sign(c), x)
        lin = jnp.asarray(0.0, c.dtype)
        if a_eq is not None:
            lin = lin - jnp.dot(y_eq, b_eq)
        if a_in is not None:
            lin = lin - jnp.dot(y_ineq, b_in)
        energy = _dual_energy(c_bar, lb, ub, lin)
        max_v_eq = (jnp.max(jnp.abs(a_eq.matvec(x) - b_eq))
                    if a_eq is not None else jnp.asarray(0.0, c.dtype))
        max_v_ineq = (jnp.max(a_in.matvec(x) - b_in)
                      if a_in is not None else jnp.asarray(0.0, c.dtype))
        metrics = dict(
            x=x, c_bar=c_bar, energy=energy, primal=jnp.dot(c, x),
            max_violated_equality=max_v_eq,
            max_violated_inequality=max_v_ineq,
        )
        return y_eq, y_ineq, key, metrics

    return run(data, y_eq, y_ineq, key)


def dual_coordinate_ascent_sharded(
    x, lp, mesh, nb_max_iter=20, callback_func=None, y_eq=None,
    y_ineq=None, max_time=None, nb_iter_plot=1, dtype=None,
    start_time=None, seed=1, use_greedy_round=True,
):
    """Mesh-parallel blocked dual coordinate ascent; same contract as the
    single-chip solver (returns ``(x, y_eq, y_ineq)``)."""
    import copy as _copy

    from ..problem import EllMatrix, default_dtype
    from ..solvers.base import HostLoop, emit_callback, to_np
    from ..solvers.dual_ascent import _color_rows

    del x
    dtype = dtype or default_dtype()
    ndev = int(np.prod(list(mesh.shape.values())))
    lp2 = _copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()

    data = dict(
        c=jnp.asarray(lp2.costsvector, dtype),
        lb=jnp.asarray(lp2.lower_bounds, dtype),
        ub=jnp.asarray(lp2.upper_bounds, dtype),
    )
    eq_sizes = in_sizes = ()
    m_eq = lp2.a_equalities.shape[0] if lp2.a_equalities is not None else 0
    m_in = (lp2.a_inequalities.shape[0]
            if lp2.a_inequalities is not None else 0)
    if m_eq:
        data["a_eq"] = EllMatrix.from_scipy(lp2.a_equalities.tocsr(),
                                            dtype=dtype)
        data["b_eq"] = jnp.asarray(lp2.b_equalities, dtype)
        eq_raw = _color_rows(lp2.a_equalities.tocsr())
        data["eq_groups"] = pad_groups(eq_raw, ndev, m_eq)
        eq_sizes = tuple(int(g.size) for g in eq_raw)
    if m_in:
        data["a_ineq"] = EllMatrix.from_scipy(lp2.a_inequalities.tocsr(),
                                              dtype=dtype)
        data["b_upper"] = jnp.asarray(lp2.b_upper, dtype)
        in_raw = _color_rows(lp2.a_inequalities.tocsr())
        data["ineq_groups"] = pad_groups(in_raw, ndev, m_in)
        in_sizes = tuple(int(g.size) for g in in_raw)

    y_eq = (jnp.zeros(m_eq, dtype) if y_eq is None
            else jnp.asarray(y_eq, dtype))
    y_ineq = (jnp.zeros(m_in, dtype) if y_ineq is None
              else jnp.asarray(y_ineq, dtype))
    key = jax.random.PRNGKey(seed)

    loop = HostLoop(start_time=start_time, max_time=max_time)
    energy = -np.inf
    x_out = np.zeros(lp2.nb_variables)
    niter = 0
    while niter < nb_max_iter:
        y_eq, y_ineq, key, metrics = sharded_dca_outer(
            data, y_eq, y_ineq, key, mesh, eq_sizes=eq_sizes,
            in_sizes=in_sizes)
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
                float(lp2.costsvector @ x_out), new_energy,
                lambda: loop.elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
            )
        # same check order as the single-chip blocked loop
        # (solvers/dual_ascent.py): timed_out first, then stall/feasible
        if loop.timed_out:
            break
        feas = (float(metrics["max_violated_inequality"]) <= 0
                and float(metrics["max_violated_equality"]) == 0)
        if stalled and feas:
            break
        energy = new_energy
    return x_out, to_np(y_eq), to_np(y_ineq)
