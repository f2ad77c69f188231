"""Mehrotra predictor-corrector primal-dual interior point method in JAX.

Reference: ``pysparselp/MehrotraPDIP.py:18-215`` (Mehrotra '92, via the
YimingYAN/mpc Matlab port) on standard form ``min cᵀx, A x = b, x ≥ 0``.

The reference solves each Newton KKT system ``[[0, A], [Aᵀ, -diag(s/x)]]``
with sparse LU (``MehrotraPDIP.py:73``), reusing the factorization between the
predictor and corrector.  Sparse LU has no XLA equivalent — and doesn't need
one: eliminating dx gives the SPD *normal equations*

    (A D Aᵀ) dy = -r_b - A(D r_c) + A(r_xs / s),      D = diag(x/s)

which this solver factors once per outer iteration as a **dense Cholesky**
(the classic normal-equations IPM formulation — what LIPSOL-style
codes do on accelerators).  Predictor and corrector share the factorization,
exactly mirroring the reference's LU reuse.  For problems whose row count
exceeds the dense threshold the solve falls back to Jacobi-preconditioned CG
on the same operator, matrix-free over the ELL layout.

The whole outer iteration (residuals, D, A D Aᵀ, Cholesky, two solves, ratio
tests, updates) is one jitted function; the host loop only reads back the
scalar residual for the convergence test and the callback.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ..ops.cg import conjgrad
from ..problem import HIGHEST, default_dtype, ell_from_scipy
from .base import to_np


def _ratio_test(v, dv, eta):
    """Largest step alpha ≤ 1 with v + alpha·dv ≥ 0, scaled by eta
    (``MehrotraPDIP.py:102-107``)."""
    ratios = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    alpha = jnp.minimum(1.0, eta * jnp.min(ratios))
    return jnp.maximum(alpha, 0.0)


@functools.partial(jax.jit, static_argnames=("use_dense",))
def _ipm_iteration(data, x, y, s, theta, ridge_boost, use_dense: bool):
    a_dense = data.get("a_dense")
    ell = data["ell"]
    b, c = data["b"], data["c"]
    n = x.shape[0]

    def matvec(v):
        return (jnp.matmul(a_dense, v, precision=HIGHEST) if use_dense
                else ell.matvec(v))

    def rmatvec(v):
        return (jnp.matmul(a_dense.T, v, precision=HIGHEST) if use_dense
                else ell.rmatvec(v))

    r_b = matvec(x) - b
    r_c = rmatvec(y) + s - c
    r_xs0 = x * s
    mu = jnp.mean(r_xs0)

    d = jnp.clip(x / jnp.maximum(s, 1e-300), 1e-12, 1e12)

    if use_dense:
        m = jnp.matmul(a_dense * d[None, :], a_dense.T, precision=HIGHEST)
        # ridge scaled with the diagonal keeps the Cholesky stable as
        # complementarity drives cond(A D Aᵀ) → ∞ near convergence; the host
        # raises ridge_boost and retries when a step still comes out non-finite
        ridge = (data["ridge"] + 1e-14 * jnp.max(jnp.diagonal(m))) * ridge_boost
        m = m + ridge * jnp.eye(m.shape[0], dtype=m.dtype)
        chol = jax.scipy.linalg.cho_factor(m, lower=False)

        def solve_normal(rhs):
            # one step of iterative refinement recovers accuracy lost to the
            # ridge and to the ill-conditioned terminal Cholesky
            dy = jax.scipy.linalg.cho_solve(chol, rhs)
            dy = dy + jax.scipy.linalg.cho_solve(
                chol, rhs - jnp.matmul(m, dy, precision=HIGHEST))
            return dy
    else:
        ridge = data["ridge"] * ridge_boost
        jac_diag = ell.sq_rowsum_weighted(d) + ridge

        def solve_normal(rhs):
            return conjgrad(
                lambda v: ell.matvec(d * ell.rmatvec(v)) + ridge * v,
                rhs,
                maxiter=200,
                tol=1e-12,
                precond=lambda v: v / jac_diag,
            )

    def newton_raw(rb, rc, r_xs):
        rhs = -rb - matvec(d * rc) + matvec(r_xs / jnp.maximum(s, 1e-300))
        dy = solve_normal(rhs)
        dx = d * (rmatvec(dy) + rc) - r_xs / jnp.maximum(s, 1e-300)
        ds = -(r_xs + s * dx) / jnp.maximum(x, 1e-300)
        return dx, dy, ds

    def newton(r_xs):
        dx, dy, ds = newton_raw(r_b, r_c, r_xs)
        # KKT-level iterative refinement (same factorization): recovers the
        # primal-feasibility digits the normal-equations reduction loses,
        # matching the reference's sparse-LU solve accuracy
        e1 = r_b + matvec(dx)                    # want A dx = -r_b
        e2 = r_c + rmatvec(dy) + ds              # want Aᵀdy + ds = -r_c
        e3 = r_xs + s * dx + x * ds              # want s dx + x ds = -r_xs
        cx, cy, cs = newton_raw(e1, e2, e3)
        return dx + cx, dy + cy, ds + cs

    # predictor (affine scaling)
    dx_aff, dy_aff, ds_aff = newton(r_xs0)
    ax_aff = _ratio_test(x, dx_aff, 1.0)
    as_aff = _ratio_test(s, ds_aff, 1.0)
    mu_aff = jnp.dot(x + ax_aff * dx_aff, s + as_aff * ds_aff) / n
    sigma = (mu_aff / jnp.maximum(mu, 1e-300)) ** 3

    # corrector (same factorization — mirrors the reference's LU reuse)
    r_xs = r_xs0 + dx_aff * ds_aff - sigma * mu
    dx_cc, dy_cc, ds_cc = newton(r_xs)

    dx = dx_aff + dx_cc
    dy = dy_aff + dy_cc
    ds = ds_aff + ds_cc
    alpha_x = _ratio_test(x, dx, theta)
    alpha_s = _ratio_test(s, ds, theta)

    x_new = x + alpha_x * dx
    y_new = y + alpha_s * dy
    s_new = s + alpha_s * ds
    finite = (
        jnp.all(jnp.isfinite(x_new))
        & jnp.all(jnp.isfinite(y_new))
        & jnp.all(jnp.isfinite(s_new))
    )
    # reject non-finite steps (ill-conditioned normal matrix at convergence):
    # keep the previous iterate; the host loop stops on the `finite` flag
    x_new = jnp.where(finite, x_new, x)
    y_new = jnp.where(finite, y_new, y)
    s_new = jnp.where(finite, s_new, s)

    residual = jnp.linalg.norm(
        jnp.concatenate((r_b, r_c, r_xs0))
    ) / data["bc"]
    return x_new, y_new, s_new, dict(
        residual=residual, mu=mu, f=jnp.dot(c, x_new),
        alpha_x=alpha_x, alpha_s=alpha_s, finite=finite,
    )


@functools.partial(jax.jit, static_argnames=("use_dense",))
def _initial_point(data, use_dense: bool):
    """Least-squares initial point (``MehrotraPDIP.py:18-53``)."""
    a_dense = data.get("a_dense")
    ell = data["ell"]
    b, c = data["b"], data["c"]
    n = c.shape[0]

    def matvec(v):
        return (jnp.matmul(a_dense, v, precision=HIGHEST) if use_dense
                else ell.matvec(v))

    def rmatvec(v):
        return (jnp.matmul(a_dense.T, v, precision=HIGHEST) if use_dense
                else ell.rmatvec(v))

    if use_dense:
        aat = jnp.matmul(a_dense, a_dense.T, precision=HIGHEST)
        aat = aat + data["ridge"] * jnp.eye(aat.shape[0], dtype=aat.dtype)
        chol = jax.scipy.linalg.cho_factor(aat, lower=False)

        def solve(rhs):
            return jax.scipy.linalg.cho_solve(chol, rhs)
    else:
        def solve(rhs):
            return conjgrad(
                lambda v: ell.matvec(ell.rmatvec(v)) + data["ridge"] * v,
                rhs, maxiter=200, tol=1e-12,
            )

    y = solve(matvec(c))
    s = c - rmatvec(y)
    x = rmatvec(solve(b))

    delta_x = jnp.maximum(-1.5 * jnp.min(x), 0.0)
    delta_s = jnp.maximum(-1.5 * jnp.min(s), 0.0)
    pdct = 0.5 * jnp.dot(x + delta_x, s + delta_s)
    delta_x_c = delta_x + pdct / jnp.maximum(jnp.sum(s) + n * delta_s, 1e-300)
    delta_s_c = delta_s + pdct / jnp.maximum(jnp.sum(x) + n * delta_x, 1e-300)
    return x + delta_x_c, y, s + delta_s_c


def mpc_sol(
    a,
    b,
    c,
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
    """Mehrotra predictor-corrector on ``min cᵀx, Ax=b, x>=0``.

    Returns ``(f, x, y, s, niter)`` — signature parity with
    ``pysparselp/MehrotraPDIP.py:110``.
    """
    del error_check
    dtype = dtype or default_dtype()
    if jnp.dtype(dtype).itemsize < 8:
        import warnings

        warnings.warn(
            "mehrotra (interior point) needs float64 arithmetic to drive "
            "the barrier parameter below ~1e-8; running in "
            f"{jnp.dtype(dtype).name} (the float32 default) will stall at a "
            "coarse tolerance. Enable jax_enable_x64 and pass "
            "dtype=np.float64, or use a first-order method in float32.",
            stacklevel=2,
        )
    a = scipy.sparse.csr_matrix(a)
    b = np.squeeze(np.asarray(b, np.float64))
    c = np.squeeze(np.asarray(c, np.float64))
    m, n = a.shape
    start = time.perf_counter() if start_time is None else start_time

    use_dense = m <= dense_threshold and m * n <= 64_000_000
    ell = ell_from_scipy(a, dtype=dtype)
    scale = max(1.0, float(abs(a).max()))
    data = dict(
        ell=ell,
        b=jnp.asarray(b, dtype),
        c=jnp.asarray(c, dtype),
        bc=jnp.asarray(
            1.0 + max(np.linalg.norm(b), np.linalg.norm(c)), dtype
        ),
        ridge=jnp.asarray(1e-12 * scale * scale * max(m, 1), dtype),
    )
    if use_dense:
        data["a_dense"] = jnp.asarray(a.toarray(), dtype)

    x, y, s = _initial_point(data, use_dense)
    theta_dev = jnp.asarray(theta, dtype)

    if verbose > 1:
        print(
            "\n%3s %6s %9s %11s %9s %9s"
            % ("ITER", "COST", "MU", "RESIDUAL", "ALPHAX", "ALPHAS")
        )

    niter_done = 0
    for niter in range(max_iter):
        ridge_boost = 1.0
        x_new, y_new, s_new, metrics = _ipm_iteration(
            data, x, y, s, theta_dev, jnp.asarray(ridge_boost, dtype), use_dense
        )
        # non-finite step: raise the regularization and retry this iteration
        retries = 0
        while not bool(metrics["finite"]) and retries < 4:
            ridge_boost *= 100.0
            retries += 1
            x_new, y_new, s_new, metrics = _ipm_iteration(
                data, x, y, s, theta_dev, jnp.asarray(ridge_boost, dtype),
                use_dense,
            )
        residual = float(metrics["residual"])
        if verbose > 1:
            print(
                "%3d %9.2e %9.2e %9.2e %9.4g %9.4g"
                % (
                    niter, float(metrics["f"]), float(metrics["mu"]),
                    residual, float(metrics["alpha_x"]),
                    float(metrics["alpha_s"]),
                )
            )
        if callback is not None:
            callback(to_np(x), niter, elapsed=time.perf_counter() - start)
        if residual < eps:
            niter_done = niter
            break
        if not bool(metrics["finite"]):
            # normal matrix became numerically singular; the previous iterate
            # is the best answer available
            niter_done = niter
            break
        x, y, s = x_new, y_new, s_new
        niter_done = niter
        if max_time is not None and time.perf_counter() - start > max_time:
            break

    f = float(jnp.dot(data["c"], x))
    return f, to_np(x), to_np(y), to_np(s), niter_done
