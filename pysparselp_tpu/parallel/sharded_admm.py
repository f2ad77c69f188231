"""Row-sharded ADMM chunks over a device mesh.

Multi-chip realizations of the two ADMM solvers (VERDICT r1 item 8; the
reference has no distributed path at all — SURVEY §5 maps its absence to
this component):

* ``lp_admm`` (penalized equalities, projected-Jacobi inner solve,
  reference ``pysparselp/ADMM.py:47-269``): the constraint system is
  row-partitioned; ``A v`` is local (x replicated), ``Aᵀ(·)`` reduces with
  ONE ``psum`` per Jacobi sweep.

* ``lp_admm2`` (exact-KKT via the Schur complement ``A Aᵀ``, reference
  ``ADMM.py:272-474``): the Schur solve runs matrix-free CG with the rows
  sharded — each CG step is one ``psum`` of an n-vector (``Aᵀv``) plus
  local tile SpMVs; dot products reduce with ``psum``.  The dense-Cholesky
  regime gathers the sharded rhs once per iteration (``all_gather``) and
  solves replicated — correct at any mesh size, chosen only when the row
  count is small enough that sharding the factor is pointless.

Same tile infrastructure as :mod:`.sharded_cp` (block-ELL per shard, both
orientations, gather-free).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .mesh import pad_gather_width
from .sharded_cp import _tiled_mv


def _chunk_tiles(a, row_lo, row_hi, dtype):
    """One shard's row block lowered to block-ELL tiles (both orientations).

    The ADMM builders keep the per-device slice loop rather than the CP
    solver's vectorized ``_chunk_tiles_all``: that path rounds shard
    heights to whole 128-row tiles, which would inflate the ADMM Schur
    systems' dimension (an ``m_pad``-sized Cholesky/CG) on small row
    counts."""
    from ..ops.bsr import _build_tile_ell

    sub = scipy.sparse.csr_matrix(a[row_lo:row_hi, :])
    tiles, cols, _, _, _ = _build_tile_ell(sub, 128, 128, dtype)
    tiles_t, rows_t, _, _, _ = _build_tile_ell(sub.T.tocsr(), 128, 128,
                                               dtype)
    return (np.asarray(tiles), np.asarray(cols), np.asarray(tiles_t),
            np.asarray(rows_t))


def build_sharded_system(a, b, mesh: Mesh, dtype):
    """Row-partition one constraint system over the mesh axis.

    Returns (data, rows_loc): per-device stacked block-ELL tiles in both
    orientations, the rhs shards, and the real-row mask."""
    axis = mesh.axis_names[0]
    ndev = int(np.prod(list(mesh.shape.values())))
    a = scipy.sparse.csr_matrix(a)
    m, n = a.shape
    rows_loc = -(-m // ndev)
    m_pad = rows_loc * ndev
    if m_pad != m:
        a = scipy.sparse.vstack(
            [a, scipy.sparse.csr_matrix((m_pad - m, n))]
        ).tocsr()
        b = np.concatenate([b, np.zeros(m_pad - m)])
    tiles_l, cols_l, tiles_tl, rows_tl, bs_l = [], [], [], [], []
    for d in range(ndev):
        lo, hi = d * rows_loc, (d + 1) * rows_loc
        tv, ci, tvt, ri = _chunk_tiles(a, lo, hi, dtype)
        tiles_l.append(tv)
        cols_l.append(ci)
        tiles_tl.append(tvt)
        rows_tl.append(ri)
        bs_l.append(b[lo:hi])
    tiles, cols = pad_gather_width(tiles_l, cols_l)
    tiles_t, rows_t = pad_gather_width(tiles_tl, rows_tl)
    bs = np.stack(bs_l)
    rm = (np.arange(m_pad) < m).astype(np.float64).reshape(ndev, rows_loc)

    shard = NamedSharding(mesh, P(axis))

    def put(x):
        x = np.asarray(x)
        t = x.dtype if np.issubdtype(x.dtype, np.integer) else dtype
        return jax.device_put(jnp.asarray(x, t), shard)

    data = dict(
        tiles=put(tiles), cols=put(cols), tiles_t=put(tiles_t),
        rows_t=put(rows_t), b=put(bs), row_mask=put(rm),
    )
    return data, rows_loc, m_pad, a


def _mv(sys_l, x, n):
    return _tiled_mv(sys_l["tiles"], sys_l["cols"], x, n,
                     sys_l["b"].shape[0])


def _rmv(sys_l, y, n):
    return _tiled_mv(sys_l["tiles_t"], sys_l["rows_t"], y,
                     sys_l["b"].shape[0], n)


def _specs(mesh, data, rep_names):
    axis = mesh.axis_names[0]
    specs = {}
    for k in data:
        specs[k] = P() if k in rep_names else P(axis)
    return specs


_REP = ("c", "lb", "ub", "gamma_eq", "gamma_ineq", "inv_diag", "omega",
        "atb", "gamma", "alpha", "ridge", "chol", "schur_inv_diag",
        "cg_tol")


@functools.partial(jax.jit, static_argnames=("mesh", "nsteps", "nb_inner"))
def admm_chunk_sharded(data, state, mesh: Mesh, nsteps: int, nb_inner: int):
    """Row-sharded twin of ``solvers.admm._admm_chunk`` (same math: damped
    projected Jacobi inner solve).  One psum per Jacobi sweep."""
    axis = mesh.axis_names[0]
    in_specs_data = _specs(mesh, data, _REP)
    in_specs_state = {"x": P(), "xp": P(), "lam": P(axis)}
    out_specs = (
        dict(in_specs_state),
        {"energy1": P(), "max_violated_equality": P(),
         "max_violated_inequality": P()},
    )

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(in_specs_data, in_specs_state),
                       out_specs=out_specs)
    def run(d, s):
        c, lb, ub = d["c"], d["lb"], d["ub"]
        gamma_eq, gamma_ineq = d["gamma_eq"], d["gamma_ineq"]
        inv_diag, omega, atb = d["inv_diag"], d["omega"], d["atb"]
        n = c.shape[0]
        loc = {k: d[k][0] for k in
               ("tiles", "cols", "tiles_t", "rows_t", "b", "row_mask")}

        def m_apply(v):
            return gamma_eq * jax.lax.psum(
                _rmv(loc, _mv(loc, v, n), n), axis) + gamma_ineq * v

        def one_iter(_, st):
            x, xp, lam = st
            y = (-c + gamma_eq * atb + gamma_ineq * xp
                 - jax.lax.psum(_rmv(loc, lam, n), axis))

            def jacobi(_, x):
                x = x + omega * (y - m_apply(x)) * inv_diag
                return jnp.clip(x, lb, ub)

            x = jax.lax.fori_loop(0, nb_inner, jacobi, x)
            lam = lam + gamma_eq * (_mv(loc, x, n) - loc["b"])
            return (x, x, lam)

        x, xp, lam = jax.lax.fori_loop(
            0, nsteps, one_iter, (s["x"], s["xp"], s["lam"][0]))

        r = (_mv(loc, x, n) - loc["b"]) * loc["row_mask"]
        energy1 = (jnp.dot(c, x)
                   + jax.lax.psum(0.5 * gamma_eq * jnp.sum(r**2)
                                  + jnp.dot(lam * loc["row_mask"], r), axis))
        metrics = dict(
            energy1=energy1,
            max_violated_equality=jax.lax.pmax(jnp.max(jnp.abs(r)), axis),
            max_violated_inequality=jnp.maximum(jnp.max(lb - x),
                                                jnp.max(x - ub)),
        )
        return {"x": x, "xp": xp, "lam": lam[None, :]}, metrics

    return run(data, state)


@functools.partial(jax.jit, static_argnames=("mesh", "nsteps", "use_dense",
                                             "cg_iters"))
def admm2_chunk_sharded(data, state, mesh: Mesh, nsteps: int,
                        use_dense: bool, cg_iters: int = 100):
    """Row-sharded twin of ``solvers.admm._admm2_chunk``: the Schur solve
    ``(A Aᵀ + ridge) ν = A y₁ − γ b`` runs sharded-CG (one psum per CG
    step) or gathered dense Cholesky."""
    axis = mesh.axis_names[0]
    in_specs_data = _specs(mesh, data, _REP)
    in_specs_state = {"x": P(), "xp": P(), "lam": P()}
    out_specs = (
        dict(in_specs_state),
        {"energy1": P(), "max_violated_equality": P(),
         "max_violated_inequality": P(), "r_primal": P(), "r_dual": P()},
    )

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(in_specs_data, in_specs_state),
                       out_specs=out_specs)
    def run(d, s):
        c, lb, ub = d["c"], d["lb"], d["ub"]
        gamma, alpha, ridge = d["gamma"], d["alpha"], d["ridge"]
        n = c.shape[0]
        loc = {k: d[k][0] for k in
               ("tiles", "cols", "tiles_t", "rows_t", "b", "row_mask")}
        m_loc = loc["b"].shape[0]

        def s_apply(v):
            # (A Aᵀ + ridge) v with v row-sharded: one psum (the Aᵀv vector)
            u = jax.lax.psum(_rmv(loc, v, n), axis)
            return _mv(loc, u, n) + ridge * v

        if use_dense:
            chol = d["chol"]

            def schur_solve(rhs_l):
                rhs = jax.lax.all_gather(rhs_l, axis, tiled=True)
                nu = jax.scipy.linalg.cho_solve((chol, False), rhs)
                i = jax.lax.axis_index(axis)
                return jax.lax.dynamic_slice(nu, (i * m_loc,), (m_loc,))
        else:
            jac = d["schur_inv_diag"]

            def schur_solve(rhs_l):
                jac_l = jax.lax.dynamic_slice(
                    jac, (jax.lax.axis_index(axis) * m_loc,), (m_loc,))

                def body(_, st):
                    v, r, z, p, rz = st
                    sp = s_apply(p)
                    denom = jax.lax.psum(jnp.dot(p, sp), axis)
                    a_k = rz / jnp.where(denom == 0, 1.0, denom)
                    v = v + a_k * p
                    r = r - a_k * sp
                    z = jac_l * r
                    rz_new = jax.lax.psum(jnp.dot(r, z), axis)
                    beta = rz_new / jnp.where(rz == 0, 1.0, rz)
                    return (v, r, z, z + beta * p, rz_new)

                v0 = jnp.zeros_like(rhs_l)
                z0 = jac_l * rhs_l
                rz0 = jax.lax.psum(jnp.dot(rhs_l, z0), axis)
                v, *_ = jax.lax.fori_loop(
                    0, cg_iters, body, (v0, rhs_l, z0, z0, rz0))
                return v

        def one_iter(_, st):
            x, xp, lam, _ = st
            xp_prev = xp
            y1 = -c + gamma * xp - lam
            rhs_l = _mv(loc, y1, n) - gamma * loc["b"]
            nu_l = schur_solve(rhs_l)
            x = (y1 - jax.lax.psum(_rmv(loc, nu_l, n), axis)) / gamma
            x = alpha * x + (1.0 - alpha) * xp
            xp = jnp.clip(x + lam / gamma, lb, ub)
            lam = lam + gamma * (x - xp)
            return (x, xp, lam, xp_prev)

        x, xp, lam, xp_prev = jax.lax.fori_loop(
            0, nsteps, one_iter, (s["x"], s["xp"], s["lam"], s["xp"]))

        r = (_mv(loc, xp, n) - loc["b"]) * loc["row_mask"]
        energy1 = (jnp.dot(c, x) + 0.5 * gamma * jnp.sum((x - xp) ** 2)
                   + jnp.dot(lam, x - xp))
        metrics = dict(
            energy1=energy1,
            max_violated_equality=jax.lax.pmax(jnp.max(jnp.abs(r)), axis),
            max_violated_inequality=jnp.asarray(0.0, x.dtype),
            r_primal=jnp.linalg.norm(x - xp),
            r_dual=gamma * jnp.linalg.norm(xp - xp_prev),
        )
        return {"x": x, "xp": xp, "lam": lam}, metrics

    return run(data, state)
