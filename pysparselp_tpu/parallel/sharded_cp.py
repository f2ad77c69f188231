"""Row-sharded Chambolle–Pock LP solver over a device mesh.

The multi-chip realization of the flagship first-order solver (SURVEY.md §5):
the constraint systems are **row-partitioned** across the mesh axis, the
primal vector ``x`` is replicated, and the dual vectors live with their rows:

* forward SpMV ``A x₃`` — purely local (x replicated): no collective;
* transpose SpMV ``yᵀA`` — each device reduces its local rows' contribution
  through its local operator (block-ELL tiles, or shift-DIA planes for
  anchor-aligned grid LPs), then one ``psum`` merges the reduced-cost
  update;
* the primal update runs replicated on every device (identical inputs →
  identical outputs, no collective needed);
* residual norms for metrics reduce with ``psum``/``pmax``.

One CP iteration therefore costs exactly one all-reduce of an ``n``-vector —
the minimal communication possible for a row-partitioned primal-dual method.
Built with ``shard_map`` so the collective schedule is explicit; XLA lowers
the all-reduce to the device interconnect's collectives.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

# what the last mesh solve ran: the layout presolve's choice, the per-shard
# operator and the devices holding the dual shards
last_plan = None


def _chunk_tiles_all(a, ndev, dtype, n):
    """Vectorized all-shards dual-orientation block-ELL lowering.

    One ``_build_tile_ell`` pass per orientation over the WHOLE matrix
    (O(nnz) host work) instead of a per-device slice loop (O(ndev·nnz)).
    Shard heights are rounded to the 128-row tile so the global tile grid
    splits exactly into per-shard grids; the transpose orientation stacks
    the per-shard ``A_dᵀ`` blocks at tile-aligned row offsets and builds
    once (every shard then shares one uniform tile count K).

    Returns ``(tiles, cols, tiles_t, rows_t, rows_loc, m_pad)`` with a
    leading mesh-axis dim on each array.
    """
    from ..ops.bsr import _build_tile_ell

    tm = 128
    group = tm
    m = a.shape[0]
    rows_loc = max(-(-m // ndev), 1)
    rows_loc = -(-rows_loc // group) * group
    m_pad = rows_loc * ndev
    coo = scipy.sparse.coo_matrix(a)

    a_pad = scipy.sparse.csr_matrix(
        (coo.data, (coo.row, coo.col)), shape=(m_pad, n))
    tiles_g, cols_g, _, _, _ = _build_tile_ell(a_pad, tm, tm, dtype)
    tiles = np.asarray(tiles_g).reshape(
        (ndev, rows_loc // tm) + tiles_g.shape[1:])
    cols = np.asarray(cols_g).reshape(ndev, rows_loc // tm, -1)

    n_tile = -(-max(n, 1) // group) * group
    d_of = coo.row // rows_loc
    bt = scipy.sparse.csr_matrix(
        (coo.data, (d_of * n_tile + coo.col, coo.row - d_of * rows_loc)),
        shape=(ndev * n_tile, rows_loc))
    tiles_tg, rows_tg, _, _, _ = _build_tile_ell(bt, tm, tm, dtype)
    tiles_t = np.asarray(tiles_tg).reshape(
        (ndev, n_tile // tm) + tiles_tg.shape[1:])
    rows_t = np.asarray(rows_tg).reshape(ndev, n_tile // tm, -1)
    return tiles, cols, tiles_t, rows_t, rows_loc, m_pad


def build_sharded_cp_data(c, a_eq, b_eq, a_ineq, b_ineq, lb, ub, mesh: Mesh,
                          alpha=1.0, dtype=np.float32, x0=None, theta=1.0,
                          y_eq0=None, y_ineq0=None, x30=None,
                          operator="tiles"):
    """Partition the (one-sided) LP by constraint rows over ``mesh``.

    Returns a dict of arrays placed with their shardings: per-device local
    operators (leading axis sharded over the mesh axis), replicated primal
    data and preconditioners, and the sharded dual state.

    ``operator`` selects the per-shard SpMV layout: ``"tiles"`` (block-ELL,
    the general case) or ``"dia"`` (per-shard diagonal planes with runtime
    offsets — for anchor-aligned grid LPs, mirroring the single-device
    path; see ``parallel/sharded_dia``)."""
    axis = mesh.axis_names[0]
    ndev = int(np.prod(list(mesh.shape.values())))
    n = c.size

    def build_system(a, b):
        if a is None or a.shape[0] == 0:
            return None
        if operator == "dia":
            from .sharded_dia import build_system_dia

            sys_d, rows_loc, m_pad = build_system_dia(a, b, ndev)
            return dict(sys_d, m=a.shape[0], m_pad=m_pad,
                        rows_loc=rows_loc)
        a = scipy.sparse.csr_matrix(a)
        m = a.shape[0]
        tiles, cols, tiles_t, rows_t, rows_loc, m_pad = _chunk_tiles_all(
            a, ndev, dtype, n)
        bs = np.concatenate([b, np.zeros(m_pad - m)]).reshape(ndev,
                                                              rows_loc)
        # per-row mask of real (non-padding) rows: exactly the global rows
        # < m.  (A genuine all-zero-coefficient row with nonzero b is still a
        # real constraint and must count in the violation metrics.)
        rm = (np.arange(m_pad) < m).astype(np.float64).reshape(ndev, rows_loc)
        return dict(
            tiles=tiles, cols=cols, tiles_t=tiles_t, rows_t=rows_t,
            b=bs, row_mask=rm, m=m, m_pad=m_pad,
            rows_loc=rows_loc,
        )

    eq = build_system(a_eq, b_eq)
    ineq = build_system(a_ineq, b_ineq)

    # diagonal preconditioners computed globally on host (setup-time;
    # shared formulas — solvers.chambolle_pock.host_preconditioners)
    from ..solvers.chambolle_pock import host_preconditioners

    diag_t, sig_eq_raw, sig_ineq_raw = host_preconditioners(
        a_eq if eq is not None else None,
        a_ineq if ineq is not None else None, alpha=alpha)

    def pad_sigma(sys_, sig):
        if sys_ is None:
            return None
        sig = np.concatenate([sig, np.zeros(sys_["m_pad"] - sys_["m"])])
        return sig.reshape(ndev, -1)

    sig_eq = pad_sigma(eq, sig_eq_raw)
    sig_ineq = pad_sigma(ineq, sig_ineq_raw)

    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put_sharded(x):
        x = np.asarray(x)
        t = x.dtype if np.issubdtype(x.dtype, np.integer) else dtype
        return jax.device_put(jnp.asarray(x, t), shard)

    def put_rep(x):
        x = np.asarray(x)
        t = x.dtype if np.issubdtype(x.dtype, np.integer) else dtype
        return jax.device_put(jnp.asarray(x, t), rep)

    data = dict(
        c=put_rep(c), lb=put_rep(lb), ub=put_rep(ub), diag_t=put_rep(diag_t),
        theta=put_rep(theta),
    )
    for name, sys_, sig in (("eq", eq, sig_eq), ("ineq", ineq, sig_ineq)):
        if sys_ is None:
            continue
        data[name] = {
            k: put_sharded(v)
            for k, v in sys_.items()
            if k not in ("m", "m_pad", "rows_loc")
        }
        data[name]["sigma"] = put_sharded(sig)
        data[name + "_m"] = sys_["m"]
        data[name + "_m_pad"] = sys_["m_pad"]

    x_init = np.zeros(n) if x0 is None else np.asarray(x0, np.float64)
    state = dict(
        x=put_rep(x_init),
        x3=put_rep(x_init if x30 is None else np.asarray(x30, np.float64)),
    )

    def y_shards(sys_, y0):
        y = np.zeros(sys_["m_pad"])
        if y0 is not None:
            y[: sys_["m"]] = np.asarray(y0, np.float64)
        return put_sharded(y.reshape(ndev, sys_["rows_loc"]))

    if eq is not None:
        state["y_eq"] = y_shards(eq, y_eq0)
    if ineq is not None:
        state["y_ineq"] = y_shards(ineq, y_ineq0)
    return data, state


def _tiled_mv(tiles, cols, x, n_in, n_out):
    """Local block-ELL SpMV: (T,K,128,128) tiles x (n_in,) -> (n_out,).

    The shared BSR tile contraction (``ops/bsr._tiled_apply``); shard
    shapes are uniform, which is all shard_map requires."""
    from ..ops.bsr import _tiled_apply

    return _tiled_apply(tiles, cols, x, n_in, n_out, 128).astype(x.dtype)


def _local_matvec(sys_l, x, n):
    """A_local @ x for one shard's row block (tiles or DIA layout)."""
    if "dia_vals" in sys_l:
        from .sharded_dia import local_matvec_dia

        return local_matvec_dia(sys_l, x, n)
    return _tiled_mv(sys_l["tiles"], sys_l["cols"], x, n,
                     sys_l["b"].shape[0])


def _local_rmatvec(sys_l, y, n):
    """A_localT @ y for one shard's row block (tiles or DIA layout)."""
    if "dia_vals" in sys_l:
        from .sharded_dia import local_rmatvec_dia

        return local_rmatvec_dia(sys_l, y, n)
    return _tiled_mv(sys_l["tiles_t"], sys_l["rows_t"], y,
                     sys_l["b"].shape[0], n)


def _make_ctx(d, axis, has_eq, has_ineq):
    """Shard-local view of the replicated problem data + per-shard row
    blocks (shared by every shard_map body in this module)."""

    def squeeze(t):
        return jax.tree.map(lambda v: v[0], t)

    return dict(
        axis=axis,
        c=d["c"], lb=d["lb"], ub=d["ub"], diag_t=d["diag_t"],
        theta=d["theta"],
        eq_l=squeeze(d["eq"]) if has_eq else None,
        in_l=squeeze(d["ineq"]) if has_ineq else None,
    )


def _iter_local(ctx, carry, omega=None):
    """One row-sharded CP iteration (one psum).  ``omega`` scales the
    primal steps by ω and the dual steps by 1/ω (the device-resident
    restart controller's primal weight); None = steps as stored."""
    axis, c = ctx["axis"], ctx["c"]
    eq_l, in_l = ctx["eq_l"], ctx["in_l"]
    n = c.shape[0]
    x, x3, y_eq, y_ineq = carry
    d_part = jnp.zeros_like(c)
    if eq_l is not None:
        d_part = d_part + _local_rmatvec(eq_l, y_eq, n)
    if in_l is not None:
        d_part = d_part + _local_rmatvec(in_l, y_ineq, n)
    dd = c + jax.lax.psum(d_part, axis)  # one all-reduce per iteration
    diag_t = ctx["diag_t"] if omega is None else ctx["diag_t"] * omega
    x2 = jnp.clip(x - diag_t * dd, ctx["lb"], ctx["ub"])
    x3 = (1.0 + ctx["theta"]) * x2 - ctx["theta"] * x
    x = x2
    if eq_l is not None:
        r = _local_matvec(eq_l, x3, n) - eq_l["b"]
        sig = eq_l["sigma"] if omega is None else eq_l["sigma"] / omega
        y_eq = y_eq + sig * r
    if in_l is not None:
        r = _local_matvec(in_l, x3, n) - in_l["b"]
        sig = in_l["sigma"] if omega is None else in_l["sigma"] / omega
        y_ineq = jnp.maximum(y_ineq + sig * r, 0.0)
    return (x, x3, y_eq, y_ineq)


def _kkt_local(ctx, x, y_eq, y_ineq):
    """KKT progress score (PDLP restart trigger), reduced over the mesh —
    multi-chip twin of ``solvers.chambolle_pock._kkt_score``."""
    axis, c = ctx["axis"], ctx["c"]
    eq_l, in_l = ctx["eq_l"], ctx["in_l"]
    n = c.shape[0]
    d_part = jnp.zeros_like(c)
    pviol = jnp.asarray(0.0, c.dtype)
    dual_loc = jnp.asarray(0.0, c.dtype)
    if eq_l is not None:
        d_part = d_part + _local_rmatvec(eq_l, y_eq, n)
        r = (_local_matvec(eq_l, x, n) - eq_l["b"]) * eq_l["row_mask"]
        pviol = pviol + jnp.sum(r * r)
        dual_loc = dual_loc - jnp.dot(y_eq, eq_l["b"])
    if in_l is not None:
        d_part = d_part + _local_rmatvec(in_l, y_ineq, n)
        r = jnp.maximum(_local_matvec(in_l, x, n) - in_l["b"],
                        0.0) * in_l["row_mask"]
        pviol = pviol + jnp.sum(r * r)
        dual_loc = dual_loc - jnp.dot(y_ineq, in_l["b"])
    dd = c + jax.lax.psum(d_part, axis)
    pviol = jax.lax.psum(pviol, axis)
    dual = jax.lax.psum(dual_loc, axis) + jnp.sum(
        jnp.where(dd < 0, dd * ctx["ub"], dd * ctx["lb"]))
    pobj = jnp.dot(c, x)
    gap = jnp.abs(pobj - dual) / (1.0 + jnp.abs(pobj) + jnp.abs(dual))
    return jnp.sqrt(pviol + gap * gap)


def _metrics_local(ctx, x, y_eq, y_ineq):
    """Chunk metrics reduced over the mesh: same quantities as the
    single-chip chunk (``chambolle_pock.cp_chunk_impl``), incl. the
    box-dual lower bound ``energy2`` and the rounded-iterate stats the
    ``force_integer`` tracking consumes."""
    axis, c = ctx["axis"], ctx["c"]
    eq_l, in_l = ctx["eq_l"], ctx["in_l"]
    n = c.shape[0]
    energy1 = jnp.dot(c, x)
    max_v_eq = jnp.asarray(0.0, c.dtype)
    max_v_ineq = jnp.asarray(0.0, c.dtype)
    x_rounded = jnp.round(x)
    energy_rounded = jnp.dot(c, x_rounded)
    rounded_feasible = jnp.asarray(True)
    d_part = jnp.zeros_like(c)
    if eq_l is not None:
        d_part = d_part + _local_rmatvec(eq_l, y_eq * eq_l["row_mask"], n)
    if in_l is not None:
        d_part = d_part + _local_rmatvec(in_l, y_ineq * in_l["row_mask"],
                                         n)
    dd = c + jax.lax.psum(d_part, axis)
    x4 = jnp.where(dd < 0, ctx["ub"], ctx["lb"])
    energy2 = jnp.dot(c, x4)
    if eq_l is not None:
        r = (_local_matvec(eq_l, x, n) - eq_l["b"]) * eq_l["row_mask"]
        energy1 = energy1 + jax.lax.psum(jnp.dot(y_eq, r), axis)
        r4 = (_local_matvec(eq_l, x4, n) - eq_l["b"]) * eq_l["row_mask"]
        energy2 = energy2 + jax.lax.psum(jnp.dot(y_eq, r4), axis)
        max_v_eq = jax.lax.pmax(jnp.max(jnp.abs(r)), axis)
        rr = (_local_matvec(eq_l, x_rounded, n)
              - eq_l["b"]) * eq_l["row_mask"]
        rounded_feasible &= jax.lax.pmax(jnp.max(jnp.abs(rr)), axis) == 0
    if in_l is not None:
        r = (_local_matvec(in_l, x, n) - in_l["b"]) * in_l["row_mask"]
        energy1 = energy1 + jax.lax.psum(jnp.dot(y_ineq, r), axis)
        r4 = (_local_matvec(in_l, x4, n) - in_l["b"]) * in_l["row_mask"]
        energy2 = energy2 + jax.lax.psum(jnp.dot(y_ineq, r4), axis)
        max_v_ineq = jax.lax.pmax(jnp.max(r), axis)
        rr = (_local_matvec(in_l, x_rounded, n)
              - in_l["b"]) * in_l["row_mask"]
        rounded_feasible &= jax.lax.pmax(jnp.max(rr), axis) <= 0
    return {
        "energy1": energy1,
        "energy2": energy2,
        "max_violated_equality": max_v_eq,
        "max_violated_inequality": max_v_ineq,
        "energy_rounded": energy_rounded,
        "rounded_feasible": rounded_feasible,
    }


_METRIC_SPECS = {
    "energy1": P(), "energy2": P(), "max_violated_equality": P(),
    "max_violated_inequality": P(), "energy_rounded": P(),
    "rounded_feasible": P(),
}


def _data_state_specs(data, axis, has_eq, has_ineq):
    in_specs_data = jax.tree.map(lambda _: P(), data)
    for name in ("eq", "ineq"):
        if name in data:
            in_specs_data[name] = jax.tree.map(lambda _: P(axis),
                                               data[name])
    state_specs = {"x": P(), "x3": P()}
    if has_eq:
        state_specs["y_eq"] = P(axis)
    if has_ineq:
        state_specs["y_ineq"] = P(axis)
    return in_specs_data, state_specs


def _unpack_state(s, dtype, has_eq, has_ineq):
    y_eq0 = s["y_eq"][0] if has_eq else jnp.zeros((0,), dtype)
    y_in0 = s["y_ineq"][0] if has_ineq else jnp.zeros((0,), dtype)
    return (s["x"], s["x3"], y_eq0, y_in0)


def _pack_state(x, x3, y_eq, y_ineq, has_eq, has_ineq):
    out = {"x": x, "x3": x3}
    if has_eq:
        out["y_eq"] = y_eq[None, :]
    if has_ineq:
        out["y_ineq"] = y_ineq[None, :]
    return out


@functools.partial(jax.jit, static_argnames=("mesh", "nsteps"))
def sharded_cp_chunk(data, state, mesh: Mesh, nsteps: int):
    """Run ``nsteps`` row-sharded CP-PPD iterations; returns (state, metrics)."""
    axis = mesh.axis_names[0]
    has_eq = "eq" in data
    has_ineq = "ineq" in data
    in_specs_data, state_specs = _data_state_specs(data, axis, has_eq,
                                                   has_ineq)
    out_specs = (dict(state_specs), dict(_METRIC_SPECS))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(in_specs_data, state_specs),
        out_specs=out_specs, check_vma=False,
    )
    def run(d, s):
        ctx = _make_ctx(d, axis, has_eq, has_ineq)
        x, x3, y_eq, y_ineq = jax.lax.fori_loop(
            0, nsteps, lambda _, carry: _iter_local(ctx, carry),
            _unpack_state(s, ctx["c"].dtype, has_eq, has_ineq)
        )
        metrics = _metrics_local(ctx, x, y_eq, y_ineq)
        return _pack_state(x, x3, y_eq, y_ineq, has_eq, has_ineq), metrics

    return run(data, state)


@functools.partial(jax.jit, static_argnames=("mesh",))
def sharded_kkt_score(data, state, mesh: Mesh):
    """KKT score of a sharded state (seeds the restart controller)."""
    axis = mesh.axis_names[0]
    has_eq = "eq" in data
    has_ineq = "ineq" in data
    in_specs_data, state_specs = _data_state_specs(data, axis, has_eq,
                                                   has_ineq)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(in_specs_data, state_specs),
        out_specs=P(), check_vma=False,
    )
    def run(d, s):
        ctx = _make_ctx(d, axis, has_eq, has_ineq)
        x, _x3, y_eq, y_ineq = _unpack_state(s, ctx["c"].dtype, has_eq,
                                             has_ineq)
        return _kkt_local(ctx, x, y_eq, y_ineq)

    return run(data, state)


@functools.partial(jax.jit, static_argnames=("mesh", "nsteps", "period"))
def sharded_cp_chunk_restart_device(data, rstate, mesh: Mesh, nsteps: int,
                                    period: int):
    """Device-resident PDLP restart controller for the row-sharded solver.

    Multi-chip twin of ``solvers.chambolle_pock._cp_chunk_restart_device``:
    runs ``nsteps`` iterations with a restart check every ``period``
    iterations entirely on device — KKT scores reduce with psum, the
    restart decision, restart-to-average selection and the primal-weight
    (ω) movement update are replicated scalar ops, and the host sees only
    the end-of-chunk metrics.  Zero host fetches per restart period.

    ``rstate`` carries the solver state plus the controller scalars
    (ω, score at last restart, last candidate score) and the last restart
    point (``zx`` replicated, ``zeq``/``zineq`` sharded with their rows).
    Step sizes in ``data`` must be UNSCALED (ω is applied inside).
    """
    axis = mesh.axis_names[0]
    has_eq = "eq" in data
    has_ineq = "ineq" in data
    beta_suf, beta_nec = 0.2, 0.8
    nblocks = max(nsteps // period, 0)
    rem = nsteps - nblocks * period

    in_specs_data, state_specs = _data_state_specs(data, axis, has_eq,
                                                   has_ineq)
    r_specs = {
        "state": dict(state_specs),
        "omega": P(), "mu_restart": P(), "mu_last": P(), "zx": P(),
    }
    if has_eq:
        r_specs["zeq"] = P(axis)
    if has_ineq:
        r_specs["zineq"] = P(axis)
    out_specs = (dict(r_specs), dict(_METRIC_SPECS))

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(in_specs_data, r_specs),
        out_specs=out_specs, check_vma=False,
    )
    def run(d, rs):
        ctx = _make_ctx(d, axis, has_eq, has_ineq)
        c = ctx["c"]
        dt = c.dtype

        # local (squeezed) controller state: tuples instead of the packed
        # (1, rows_loc) device-axis layout
        rsl = {
            "state": _unpack_state(rs["state"], dt, has_eq, has_ineq),
            "omega": rs["omega"],
            "mu_restart": rs["mu_restart"],
            "mu_last": rs["mu_last"],
            "zx": rs["zx"],
            "zeq": rs["zeq"][0] if has_eq else jnp.zeros((0,), dt),
            "zineq": rs["zineq"][0] if has_ineq else jnp.zeros((0,), dt),
        }

        def run_block(rsl):
            omega = rsl["omega"]

            def body(_, carry):
                s, (sx, se, si) = carry
                s = _iter_local(ctx, s, omega)
                return s, (sx + s[0], se + s[2], si + s[3])

            s0 = rsl["state"]
            sums0 = (jnp.zeros_like(c), jnp.zeros_like(s0[2]),
                     jnp.zeros_like(s0[3]))
            state, (sx, se, si) = jax.lax.fori_loop(0, period, body,
                                                    (s0, sums0))
            inv = 1.0 / period
            ax, ae, ai = sx * inv, se * inv, si * inv
            s_cur = _kkt_local(ctx, state[0], state[2], state[3])
            s_avg = _kkt_local(ctx, ax, ae, ai)
            mu_c = jnp.minimum(s_cur, s_avg)
            do = (mu_c <= beta_suf * rsl["mu_restart"]) | (
                (mu_c <= beta_nec * rsl["mu_restart"])
                & (mu_c > rsl["mu_last"])
            )
            use_avg = s_avg < s_cur
            zx = jnp.where(use_avg, ax, state[0])
            zeq = jnp.where(use_avg, ae, state[2])
            zineq = jnp.where(use_avg, ai, state[3])
            dx = jnp.linalg.norm(zx - rsl["zx"])
            dy = jnp.sqrt(jax.lax.psum(
                jnp.sum((zeq - rsl["zeq"]) ** 2)
                + jnp.sum((zineq - rsl["zineq"]) ** 2), axis))
            valid = (dx > 1e-30) & (dy > 1e-30)
            # ω is the PRIMAL weight (diag_t scales with ω): the PDLP
            # movement update uses Δx/Δy
            om_new = jnp.where(
                do & valid,
                jnp.exp(0.5 * jnp.log(dx / jnp.maximum(dy, 1e-30))
                        + 0.5 * jnp.log(omega)),
                omega,
            )
            new_state = (
                jnp.where(do, zx, state[0]),
                jnp.where(do, zx, state[1]),
                jnp.where(do, zeq, state[2]),
                jnp.where(do, zineq, state[3]),
            )
            return {
                "state": new_state,
                "omega": om_new,
                "mu_restart": jnp.where(do, mu_c, rsl["mu_restart"]),
                "mu_last": jnp.where(do, jnp.asarray(jnp.inf, mu_c.dtype),
                                     mu_c),
                "zx": jnp.where(do, zx, rsl["zx"]),
                "zeq": jnp.where(do, zeq, rsl["zeq"]),
                "zineq": jnp.where(do, zineq, rsl["zineq"]),
            }

        rsl = jax.lax.fori_loop(0, nblocks, lambda _, r: run_block(r), rsl)
        if rem:
            omega = rsl["omega"]
            state = jax.lax.fori_loop(
                0, rem, lambda _, s: _iter_local(ctx, s, omega),
                rsl["state"])
            rsl = dict(rsl, state=state)

        x, x3, y_eq, y_ineq = rsl["state"]
        metrics = _metrics_local(ctx, x, y_eq, y_ineq)
        out = {
            "state": _pack_state(x, x3, y_eq, y_ineq, has_eq, has_ineq),
            "omega": rsl["omega"],
            "mu_restart": rsl["mu_restart"],
            "mu_last": rsl["mu_last"],
            "zx": rsl["zx"],
        }
        if has_eq:
            out["zeq"] = rsl["zeq"][None, :]
        if has_ineq:
            out["zineq"] = rsl["zineq"][None, :]
        return out, metrics

    return run(data, rstate)


def chambolle_pock_ppd_sharded(
    c, a_eq, beq, a_ineq, b_lower, b_upper, lb, ub, mesh,
    nb_max_iter=1000, nb_iter_plot=100, callback_func=None, max_time=None,
    dtype=np.float32, alpha=1.0, restart=None, omega=None, permute="auto",
    x0=None, theta=1.0, stop_tol=None, start_time=None, y_eq0=None,
    y_ineq0=None, x30=None, restart_period=None, save_problem=False,
    force_integer=False, light_metrics=False,
):
    """Mesh-parallel CP-PPD with the standard solver contract; returns x
    (or ``(x, best_integer_solution)`` when ``force_integer=True``).

    ``restart``/``omega`` mirror the single-chip solver's PDLP-style
    acceleration — the controller runs DEVICE-RESIDENT inside the sharded
    chunk (:func:`sharded_cp_chunk_restart_device`): restart decisions,
    ω updates and restart-point state never leave the mesh, and all
    scoring reduces with psum.  ``permute`` mirrors the single-device
    RCM/align layout presolve; an aligned layout runs per-shard DIA.
    ``theta``/``stop_tol``/``y_eq0``/``y_ineq0``/``x30`` complete kwarg
    parity with the single-chip solver (full-state resume included);
    ``force_integer`` tracks the best feasible integer-rounded iterate
    (feasibility pmax-reduced, energy psum-reduced over shards)."""
    import time


    from ..solvers.base import (chunk_schedule, emit_callback,
                                mirror_callback_attrs)
    from ..solvers.chambolle_pock import _fold_one_sided, estimate_omega

    del save_problem  # repro dumps are handled by utils.save_arguments
    if restart is not None and omega is None:
        omega = "auto"
    a_one, b_ineq = _fold_one_sided(a_ineq, b_lower, b_upper)
    if omega == "auto":
        omega = estimate_omega(c, beq if a_eq is not None else None, b_ineq)
    omega = float(omega) if omega is not None else 1.0

    if permute is True:
        permute = "rcm"
    c = np.asarray(c, np.float64)
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    inv_cols = None
    operator = "tiles"
    choice = None
    if permute and (a_eq is not None or a_one is not None):
        choice = permute if permute in ("rcm", "align") else None
        align_plan = None
        if choice is None:
            from ..solvers.chambolle_pock import _choose_layout

            choice, align_plan = _choose_layout(
                [a_eq, a_one],
                jnp.float32 if np.dtype(dtype) == np.float32
                else jnp.float64)
        # shared presolve helpers (problem.py): the embedding/permutation
        # conventions stay identical to the single-chip driver
        from ..problem import (anchor_align, apply_align_embedding,
                               apply_rcm_permutation)

        sys = dict(a_eq=a_eq, beq=beq, a_ineq=a_one, b_ineq=b_ineq,
                   c=c, lb=lb, ub=ub, x0=x0, x30=x30,
                   y_eq0=y_eq0, y_ineq0=y_ineq0)
        col_pos = None
        if choice == "align":
            plan = (align_plan if align_plan is not None
                    else anchor_align([a_eq, a_one]))
            sys, _pe, _pi, col_pos = apply_align_embedding(plan, sys)
            operator = "dia"
        elif choice == "rcm":
            sys, _pe, _pi, col_pos = apply_rcm_permutation(sys)
        if col_pos is not None:
            a_eq, beq = sys["a_eq"], sys["beq"]
            a_one, b_ineq = sys["a_ineq"], sys["b_ineq"]
            c, lb, ub = sys["c"], sys["lb"], sys["ub"]
            x0, x30 = sys["x0"], sys["x30"]
            y_eq0, y_ineq0 = sys["y_eq0"], sys["y_ineq0"]
            inv_cols = col_pos
        if inv_cols is not None and callback_func is not None:
            user_cb = callback_func

            if getattr(user_cb, "wants_solution", True):
                def callback_func(niter, xp, *rest):
                    user_cb(niter, np.asarray(xp)[inv_cols], *rest)
            else:
                def callback_func(niter, xp, *rest):
                    user_cb(niter, xp, *rest)
            # keep the protocol attributes visible to the chunk loop
            mirror_callback_attrs(callback_func, user_cb)
    data, state = build_sharded_cp_data(
        c, a_eq, beq, a_one, b_ineq, lb, ub, mesh,
        alpha=alpha, dtype=dtype, x0=x0, theta=theta,
        y_eq0=y_eq0, y_ineq0=y_ineq0, x30=x30, operator=operator,
    )
    if omega != 1.0 and restart != "average":
        # without the restart controller the primal weight is a one-time
        # rescale of the stored step sizes; the controller instead keeps ω
        # device-resident and applies it inside the chunk
        data = _rescale_steps(data, omega)

    start = time.perf_counter() if start_time is None else start_time
    # restart checks run on DEVICE every ``period`` iterations (the
    # single-chip solver's restart_period semantics: at most nb_iter_plot)
    period = int(min(restart_period or nb_iter_plot, nb_iter_plot))
    rstate = None
    best_integer_solution = None
    best_integer_energy = np.inf
    niter = 0
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        if restart == "average":
            if rstate is None:
                # controller seeded with the KKT score of the initial
                # point (device computation, no host fetch)
                dt = data["c"].dtype
                rstate = {
                    "state": state,
                    "omega": jnp.asarray(omega, dt),
                    "mu_restart": sharded_kkt_score(data, state, mesh),
                    "mu_last": jnp.asarray(np.inf, dt),
                    "zx": state["x"],
                }
                if "y_eq" in state:
                    rstate["zeq"] = state["y_eq"]
                if "y_ineq" in state:
                    rstate["zineq"] = state["y_ineq"]
            rstate, metrics = sharded_cp_chunk_restart_device(
                data, rstate, mesh, nsteps, period)
            state = rstate["state"]
        else:
            state, metrics = sharded_cp_chunk(data, state, mesh, nsteps)
        niter += nsteps
        if force_integer and bool(metrics["rounded_feasible"]):
            er = float(metrics["energy_rounded"])
            if er < best_integer_energy:
                best_integer_energy = er
                best_integer_solution = np.round(np.asarray(state["x"]))
        if light_metrics:
            # single-fetch checkpoint: emit_callback(light=True) fetches
            # energy1 (which synchronizes the async chunk) and passes the
            # sharded x through unfetched
            emit_callback(
                callback_func, niter, state["x"],
                metrics["energy1"], metrics["energy2"],
                lambda: time.perf_counter() - start,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
                light=True,
            )
            elapsed = time.perf_counter() - start
        else:
            x_host = np.asarray(state["x"])  # forces the chunk to finish
            elapsed = time.perf_counter() - start
            emit_callback(
                callback_func, niter, x_host,
                metrics["energy1"], metrics["energy2"], elapsed,
                metrics["max_violated_equality"],
                metrics["max_violated_inequality"],
            )
        if max_time is not None and elapsed > max_time:
            break
        if stop_tol is not None:
            # same criterion as the single-chip solver: feasibility plus
            # the relative primal-dual gap of the chunk metrics
            e1, e2 = float(metrics["energy1"]), float(metrics["energy2"])
            gap = abs(e1 - e2) / (1.0 + abs(e1) + abs(e2))
            feas = max(float(metrics["max_violated_equality"]),
                       float(metrics["max_violated_inequality"]))
            if feas < stop_tol and gap < stop_tol:
                break
    global last_plan
    y_shard = state["y_ineq" if "y_ineq" in state else "y_eq"]
    last_plan = {
        "layout": choice, "operator": operator,
        "shard_devices": [s.device.id for s in y_shard.addressable_shards],
    }
    x_final = np.asarray(state["x"], np.float64)
    if inv_cols is not None:
        x_final = x_final[inv_cols]
        if best_integer_solution is not None:
            best_integer_solution = best_integer_solution[inv_cols]
    if force_integer:
        return x_final, best_integer_solution
    return x_final


def _rescale_steps(data, ratio):
    data = dict(data)
    data["diag_t"] = data["diag_t"] * ratio
    for name in ("eq", "ineq"):
        if name in data:
            sys_ = dict(data[name])
            sys_["sigma"] = sys_["sigma"] / ratio
            data[name] = sys_
    return data
