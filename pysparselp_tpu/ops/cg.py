"""Conjugate-gradient linear solvers (device-side, matrix-free).

Device-side replacement for the reference's direct sparse factorizations
(SuperLU in ``ADMM.py:105``, ``MehrotraPDIP.py:73``) and its textbook CG
(``conjugateGradientLinearSolver.py:30-52``): sparse LU has no XLA story, so
the framework solves SPD systems either with dense Cholesky (small
systems) or with (preconditioned) CG built from SpMV gathers (large systems).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def conjgrad(matvec, b, x0=None, maxiter=100, tol=1e-10, precond=None):
    """Preconditioned conjugate gradient for SPD ``A x = b``.

    Args:
      matvec: function computing ``A @ v``.
      b: right-hand side.
      x0: initial guess (zeros if None).
      maxiter: static iteration cap (the loop is a ``lax.while_loop``; it
        exits early on the residual test but compiles once).
      tol: relative residual tolerance.
      precond: optional function computing ``M⁻¹ v``.

    Returns the solution estimate.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r) if precond is not None else r
    p = z
    rz = jnp.vdot(r, z)
    bnorm = jnp.maximum(jnp.linalg.norm(b), 1e-300)

    def cond(carry):
        x, r, z, p, rz, k = carry
        return (k < maxiter) & (jnp.linalg.norm(r) > tol * bnorm)

    def body(carry):
        x, r, z, p, rz, k = carry
        ap = matvec(p)
        denom = jnp.vdot(p, ap)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r) if precond is not None else r
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, z, p, rz, k = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.asarray(0))
    )
    return x
