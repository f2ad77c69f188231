"""Column-sharded Mehrotra predictor-corrector IPM over a device mesh.

Multi-chip realization of the interior-point solver
(:mod:`pysparselp_tpu.solvers.mehrotra`; reference algorithm
``pysparselp/MehrotraPDIP.py:56-99``) on standard form
``min cᵀx, A x = b, x ≥ 0``.

The natural partition for the normal-equations IPM is **columns** (the
variables): with ``A = [A_1 | … | A_D]`` column-partitioned over the mesh,

* ``x, s, c`` live with their columns (sharded); ``y, b`` (row space) are
  replicated;
* the normal matrix is a psum of shard-local contributions,
  ``A D Aᵀ = Σ_d A_d D_d A_dᵀ`` — each device computes its local
  ``(m × n_loc) · (n_loc × m)`` product and one ``psum`` merges them;
  the Cholesky factorization runs replicated (identical inputs on every
  device — no collective needed);
* matvec ``A x = Σ_d A_d x_d`` is one psum; ``Aᵀ y`` is purely local;
* in the matrix-free regime (``m`` beyond the dense threshold) each CG
  step on ``A D Aᵀ`` costs exactly one psum — the same minimal collective
  schedule as the row-sharded first-order solvers;
* ratio tests reduce with ``pmin``, complementarity/residual sums with
  ``psum``.

Columns are padded to a mesh multiple; padded entries are masked out of
every reduction (``col_mask``), so the trajectory is bitwise the
single-chip trajectory up to float reassociation of the reductions.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.cg import conjgrad
from ..problem import HIGHEST, default_dtype
from ..solvers.base import to_np
from .mesh import pad_gather_width


def build_sharded_ipm_data(a, b, c, mesh: Mesh, dtype, dense_threshold):
    """Column-partition the standard-form system over ``mesh``.

    Returns ``(data, n_loc, use_dense)``; ``data`` holds device-placed
    arrays — shard-leading-axis for per-column data, replicated for the
    row space."""
    axis = mesh.axis_names[0]
    ndev = int(np.prod(list(mesh.shape.values())))
    a = scipy.sparse.csr_matrix(a)
    m, n = a.shape
    n_loc = -(-n // ndev)
    n_pad = n_loc * ndev

    use_dense = m <= dense_threshold and m * n_pad <= 64_000_000

    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    col_mask = (np.arange(n_pad) < n).astype(np.float64)
    c_pad = np.zeros(n_pad)
    c_pad[:n] = np.asarray(c, np.float64)

    data = dict(
        b=jax.device_put(jnp.asarray(np.asarray(b, np.float64), dtype),
                         rep),
        c=jax.device_put(jnp.asarray(c_pad.reshape(ndev, n_loc), dtype),
                         shard),
        col_mask=jax.device_put(
            jnp.asarray(col_mask.reshape(ndev, n_loc), dtype), shard),
        bc=jax.device_put(jnp.asarray(
            1.0 + max(np.linalg.norm(b), np.linalg.norm(c)), dtype), rep),
        ridge=jax.device_put(jnp.asarray(
            1e-12 * max(1.0, float(abs(a).max())) ** 2 * max(m, 1), dtype),
            rep),
    )
    csc = a.tocsc()
    if use_dense:
        a_loc = np.zeros((ndev, m, n_loc))
        dense = a.toarray()
        for d in range(ndev):
            lo = d * n_loc
            hi = max(min(lo + n_loc, n), lo)  # all-padding shards: empty
            a_loc[d, :, : hi - lo] = dense[:, lo:hi]
        data["a"] = jax.device_put(jnp.asarray(a_loc, dtype), shard)
    else:
        # per-shard dual-orientation ELL, padded to a common gather width
        from ..problem import EllMatrix

        vs, cs, vts, rts = [], [], [], []
        for d in range(ndev):
            lo = d * n_loc
            hi = max(min(lo + n_loc, n), lo)  # all-padding shards: empty
            sub = csc[:, lo:hi]
            if sub.shape[1] < n_loc:
                sub = scipy.sparse.hstack(
                    [sub, scipy.sparse.csc_matrix((m, n_loc - sub.shape[1]))]
                )
            e = EllMatrix.from_scipy(sub.tocsr(), dtype=jnp.float64)
            vs.append(np.asarray(e.vals))
            cs.append(np.asarray(e.cols))
            vts.append(np.asarray(e.vals_t))
            rts.append(np.asarray(e.rows_t))
        vals, cols = pad_gather_width(vs, cs)
        vals_t, rows_t = pad_gather_width(vts, rts)
        data["ell_vals"] = jax.device_put(jnp.asarray(vals, dtype), shard)
        data["ell_cols"] = jax.device_put(jnp.asarray(cols), shard)
        data["ell_vals_t"] = jax.device_put(jnp.asarray(vals_t, dtype),
                                            shard)
        data["ell_rows_t"] = jax.device_put(jnp.asarray(rows_t), shard)
    return data, n_loc, use_dense


def _specs(data, axis):
    sp = {k: P() for k in data}
    for k in ("c", "col_mask", "a", "ell_vals", "ell_cols", "ell_vals_t",
              "ell_rows_t"):
        if k in data:
            sp[k] = P(axis)
    return sp


def _local_ops(d, use_dense, axis):
    """(matvec, rmatvec, wrowsum) closures over one shard's column block."""
    if use_dense:
        a = d["a"][0]

        def matvec(v):          # full (m,), one psum
            return jax.lax.psum(jnp.matmul(a, v, precision=HIGHEST), axis)

        def rmatvec(y):         # local (n_loc,)
            return jnp.matmul(a.T, y, precision=HIGHEST)

        def wrowsum(w):         # diag(A diag(w) Aᵀ) contribution, replicated
            return jax.lax.psum(
                jnp.matmul(a * a, w, precision=HIGHEST), axis)
    else:
        vals, cols = d["ell_vals"][0], d["ell_cols"][0]
        vals_t, rows_t = d["ell_vals_t"][0], d["ell_rows_t"][0]

        def matvec(v):
            return jax.lax.psum(
                jnp.sum(vals * jnp.take(v, cols, axis=0), axis=1), axis)

        def rmatvec(y):
            return jnp.sum(vals_t * jnp.take(y, rows_t, axis=0), axis=1)

        def wrowsum(w):
            return jax.lax.psum(
                jnp.sum(vals**2 * jnp.take(w, cols, axis=0), axis=1), axis)
    return matvec, rmatvec, wrowsum


@functools.partial(jax.jit, static_argnames=("mesh", "use_dense", "n_true"))
def _ipm_iteration_sharded(data, x, y, s, theta, ridge_boost, mesh: Mesh,
                           use_dense: bool, n_true: int):
    """One sharded predictor-corrector iteration (twin of
    ``solvers.mehrotra._ipm_iteration``; padded columns masked out of all
    reductions)."""
    axis = mesh.axis_names[0]
    dsp = _specs(data, axis)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(dsp, P(axis), P(), P(axis), P(), P()),
        out_specs=(P(axis), P(), P(axis),
                   {k: P() for k in ("residual", "mu", "f", "alpha_x",
                                     "alpha_s", "finite")}),
        check_vma=False,
    )
    def run(d, x_s, y, s_s, theta, ridge_boost):
        matvec, rmatvec, wrowsum = _local_ops(d, use_dense, axis)
        cm = d["col_mask"][0]
        c = d["c"][0]
        b = d["b"]
        x = x_s[0]
        s = s_s[0]

        r_b = matvec(x) - b
        r_c = (rmatvec(y) + s - c) * cm
        r_xs0 = x * s * cm
        mu = jax.lax.psum(jnp.sum(r_xs0), axis) / n_true

        dd = jnp.clip(x / jnp.maximum(s, 1e-300), 1e-12, 1e12) * cm

        if use_dense:
            a = d["a"][0]
            m_mat = jax.lax.psum(jnp.matmul(
                a * dd[None, :], a.T, precision=HIGHEST), axis)
            ridge = (d["ridge"] + 1e-14 * jnp.max(jnp.diagonal(m_mat))
                     ) * ridge_boost
            m_mat = m_mat + ridge * jnp.eye(m_mat.shape[0],
                                            dtype=m_mat.dtype)
            chol = jax.scipy.linalg.cho_factor(m_mat, lower=False)

            def solve_normal(rhs):
                dy = jax.scipy.linalg.cho_solve(chol, rhs)
                return dy + jax.scipy.linalg.cho_solve(
                    chol, rhs - jnp.matmul(m_mat, dy, precision=HIGHEST))
        else:
            ridge = d["ridge"] * ridge_boost
            jac_diag = wrowsum(dd) + ridge

            def solve_normal(rhs):
                # one psum per CG step (inside matvec)
                return conjgrad(
                    lambda v: matvec(dd * rmatvec(v)) + ridge * v,
                    rhs, maxiter=200, tol=1e-12,
                    precond=lambda v: v / jac_diag,
                )

        def newton_raw(rb, rc, r_xs):
            rhs = -rb - matvec(dd * rc) + matvec(
                r_xs / jnp.maximum(s, 1e-300))
            dy = solve_normal(rhs)
            dx = dd * (rmatvec(dy) + rc) - r_xs / jnp.maximum(s, 1e-300)
            ds = -(r_xs + s * dx) / jnp.maximum(x, 1e-300)
            return dx * cm, dy, ds * cm

        def newton(r_xs):
            dx, dy, ds = newton_raw(r_b, r_c, r_xs)
            e1 = r_b + matvec(dx)
            e2 = (r_c + rmatvec(dy) + ds) * cm
            e3 = (r_xs + s * dx + x * ds) * cm
            cx, cy, cs = newton_raw(e1, e2, e3)
            return dx + cx, dy + cy, ds + cs

        def ratio_test(v, dv, eta):
            neg = (dv < 0) & (cm > 0)
            ratios = jnp.where(neg, -v / jnp.where(neg, dv, -1.0), jnp.inf)
            rmin = jax.lax.pmin(jnp.min(ratios, initial=jnp.inf), axis)
            return jnp.maximum(jnp.minimum(1.0, eta * rmin), 0.0)

        dx_aff, dy_aff, ds_aff = newton(r_xs0)
        ax_aff = ratio_test(x, dx_aff, 1.0)
        as_aff = ratio_test(s, ds_aff, 1.0)
        mu_aff = jax.lax.psum(jnp.dot(
            (x + ax_aff * dx_aff) * cm, s + as_aff * ds_aff), axis) / n_true
        sigma = (mu_aff / jnp.maximum(mu, 1e-300)) ** 3

        r_xs = r_xs0 + (dx_aff * ds_aff - sigma * mu) * cm
        dx_cc, dy_cc, ds_cc = newton(r_xs)

        dx = dx_aff + dx_cc
        dy = dy_aff + dy_cc
        ds = ds_aff + ds_cc
        alpha_x = ratio_test(x, dx, theta)
        alpha_s = ratio_test(s, ds, theta)

        x_new = x + alpha_x * dx
        y_new = y + alpha_s * dy
        s_new = s + alpha_s * ds
        fin_loc = (jnp.all(jnp.isfinite(x_new))
                   & jnp.all(jnp.isfinite(s_new)))
        finite = (jax.lax.psum(1.0 - fin_loc.astype(x.dtype), axis) == 0
                  ) & jnp.all(jnp.isfinite(y_new))
        x_new = jnp.where(finite, x_new, x)
        y_new = jnp.where(finite, y_new, y)
        s_new = jnp.where(finite, s_new, s)

        res_sq = jax.lax.psum(jnp.sum(r_c * r_c) + jnp.sum(r_xs0 * r_xs0),
                              axis) + jnp.sum(r_b * r_b)
        residual = jnp.sqrt(res_sq) / d["bc"]
        f = jax.lax.psum(jnp.dot(c, x_new * cm), axis)
        metrics = dict(residual=residual, mu=mu, f=f, alpha_x=alpha_x,
                       alpha_s=alpha_s, finite=finite)
        return x_new[None, :], y_new, s_new[None, :], metrics

    return run(data, x, y, s, theta, ridge_boost)


@functools.partial(jax.jit, static_argnames=("mesh", "use_dense", "n_true"))
def _initial_point_sharded(data, mesh: Mesh, use_dense: bool, n_true: int):
    """Sharded least-squares initial point (twin of
    ``solvers.mehrotra._initial_point``)."""
    axis = mesh.axis_names[0]
    dsp = _specs(data, axis)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(dsp,),
        out_specs=(P(axis), P(), P(axis)), check_vma=False,
    )
    def run(d):
        matvec, rmatvec, wrowsum = _local_ops(d, use_dense, axis)
        cm = d["col_mask"][0]
        c = d["c"][0]
        b = d["b"]

        if use_dense:
            a = d["a"][0]
            aat = jax.lax.psum(
                jnp.matmul(a, a.T, precision=HIGHEST), axis)
            aat = aat + d["ridge"] * jnp.eye(aat.shape[0], dtype=aat.dtype)
            chol = jax.scipy.linalg.cho_factor(aat, lower=False)

            def solve(rhs):
                return jax.scipy.linalg.cho_solve(chol, rhs)
        else:
            def solve(rhs):
                return conjgrad(
                    lambda v: matvec(rmatvec(v)) + d["ridge"] * v,
                    rhs, maxiter=200, tol=1e-12,
                )

        y = solve(matvec(c))
        s = (c - rmatvec(y)) * cm
        x = rmatvec(solve(b)) * cm

        def masked_min(v):
            return jax.lax.pmin(
                jnp.min(jnp.where(cm > 0, v, jnp.inf), initial=jnp.inf),
                axis)

        delta_x = jnp.maximum(-1.5 * masked_min(x), 0.0)
        delta_s = jnp.maximum(-1.5 * masked_min(s), 0.0)
        pdct = 0.5 * jax.lax.psum(
            jnp.dot((x + delta_x) * cm, s + delta_s), axis)
        sum_s = jax.lax.psum(jnp.dot(s, cm), axis)
        sum_x = jax.lax.psum(jnp.dot(x, cm), axis)
        delta_x_c = delta_x + pdct / jnp.maximum(
            sum_s + n_true * delta_s, 1e-300)
        delta_s_c = delta_s + pdct / jnp.maximum(
            sum_x + n_true * delta_x, 1e-300)
        return ((x + delta_x_c * cm)[None, :], y,
                (s + delta_s_c * cm)[None, :])

    return run(data)


def mpc_sol_sharded(
    a,
    b,
    c,
    mesh: Mesh,
    max_iter=100,
    eps=1e-9,
    theta=0.9995,
    verbose=0,
    error_check=False,
    callback=None,
    dtype=None,
    dense_threshold=4096,
    start_time=None,
    max_time=None,
):
    """Mesh-parallel Mehrotra predictor-corrector on
    ``min cᵀx, Ax=b, x ≥ 0``; returns ``(f, x, y, s, niter)`` (signature
    parity with :func:`~pysparselp_tpu.solvers.mehrotra.mpc_sol`)."""
    del error_check
    dtype = dtype or default_dtype()
    a = scipy.sparse.csr_matrix(a)
    b = np.squeeze(np.asarray(b, np.float64))
    c = np.squeeze(np.asarray(c, np.float64))
    n = c.size
    start = time.perf_counter() if start_time is None else start_time

    data, n_loc, use_dense = build_sharded_ipm_data(
        a, b, c, mesh, dtype, dense_threshold)
    x, y, s = _initial_point_sharded(data, mesh, use_dense, n)
    theta_dev = jnp.asarray(theta, dtype)

    def x_host(x_s):
        return np.asarray(x_s, np.float64).reshape(-1)[:n]

    niter_done = 0
    for niter in range(max_iter):
        ridge_boost = 1.0
        x_new, y_new, s_new, metrics = _ipm_iteration_sharded(
            data, x, y, s, theta_dev, jnp.asarray(ridge_boost, dtype),
            mesh, use_dense, n)
        retries = 0
        while not bool(metrics["finite"]) and retries < 4:
            ridge_boost *= 100.0
            retries += 1
            x_new, y_new, s_new, metrics = _ipm_iteration_sharded(
                data, x, y, s, theta_dev, jnp.asarray(ridge_boost, dtype),
                mesh, use_dense, n)
        residual = float(metrics["residual"])
        if verbose > 1:
            print("%3d %9.2e %9.2e %9.2e" % (niter, float(metrics["f"]),
                                             float(metrics["mu"]),
                                             residual))
        if callback is not None:
            callback(x_host(x), niter,
                     elapsed=time.perf_counter() - start)
        if residual < eps:
            niter_done = niter
            break
        if not bool(metrics["finite"]):
            niter_done = niter
            break
        x, y, s = x_new, y_new, s_new
        niter_done = niter
        if max_time is not None and time.perf_counter() - start > max_time:
            break

    xh = x_host(x)
    f = float(np.dot(c, xh))
    return f, xh, to_np(y), x_host(s), niter_done
