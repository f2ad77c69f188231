"""Factor-once linear-system solvers for SPD systems on the device.

Framework counterpart of the reference's ``CholeskyOrLu`` wrapper
(``pysparselp/tools.py:74-86``), which hides scikits-CHOLMOD vs scipy-LU
behind one ``solve`` method.  On the device there is no sparse direct
factorization; the two strategies are

* :class:`DenseCholesky` — densify (small/medium systems), one dense
  ``cho_factor``; every ``solve`` is two triangular solves.  This is the
  analogue of the reference's factor-once ``splu`` reuse
  (``ADMM.py:342``, ``MehrotraPDIP.py:73``).
* :class:`CgSolver` — matrix-free (Jacobi-)preconditioned conjugate
  gradient for systems too large to densify.

``make_spd_solver`` picks between them by size, mirroring how the solvers
in :mod:`pysparselp_tpu.solvers.admm` / ``mehrotra`` choose their path.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from .cg import conjgrad

DENSE_MAX_DIM = 4096


class DenseCholesky:
    """Factor an SPD operator once (dense, on device); solve many times."""

    def __init__(self, m, dtype=None, ridge=0.0):
        if scipy.sparse.issparse(m):
            m = m.toarray()
        m = jnp.asarray(m, dtype)
        if ridge:
            m = m + ridge * jnp.eye(m.shape[0], dtype=m.dtype)
        self.chol = jsl.cho_factor(m)

    def solve(self, b):
        return jsl.cho_solve(self.chol, jnp.asarray(b, self.chol[0].dtype))


class CgSolver:
    """Matrix-free CG with optional diagonal preconditioner."""

    def __init__(self, matvec, diag=None, maxiter=200, tol=1e-10):
        self.matvec = matvec
        self.maxiter = maxiter
        self.tol = tol
        self.precond = None
        if diag is not None:
            inv = 1.0 / jnp.where(diag == 0, 1.0, diag)
            self.precond = lambda r: inv * r

    def solve(self, b, x0=None):
        return conjgrad(self.matvec, b, x0=x0, maxiter=self.maxiter,
                        tol=self.tol, precond=self.precond)


def make_spd_solver(m=None, matvec=None, diag=None, dtype=None,
                    dense_max_dim=DENSE_MAX_DIM, maxiter=200, ridge=0.0):
    """Return a factor-once solver for an SPD system.

    Pass the explicit matrix ``m`` (dense Cholesky when ``dim ≤
    dense_max_dim``) and/or a ``matvec`` closure (CG fallback).
    """
    if m is not None and m.shape[0] <= dense_max_dim:
        return DenseCholesky(m, dtype=dtype, ridge=ridge)
    if matvec is None:
        if m is None:
            raise ValueError("need m or matvec")
        from ..problem import ell_from_scipy

        mm = scipy.sparse.csr_matrix(m)
        op = ell_from_scipy(mm, dtype=dtype)
        matvec = op.matvec
        if diag is None:
            diag = jnp.asarray(mm.diagonal())
    return CgSolver(matvec, diag=diag, maxiter=maxiter)
