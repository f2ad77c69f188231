"""ADMM LP solvers in JAX.

* ``lp_admm`` — penalized-equality ADMM (reference ``pysparselp/ADMM.py:47-269``):
  the x-subproblem ``min ½xᵀMx − yᵀx`` with ``M = γₑAᵀA + γᵢI`` under box
  constraints.  The reference's default inner solver is a sequential bounded
  Gauss–Seidel sweep in Cython (``gaussSiedel.pyx:95-153``) — inherently
  serial.  The device inner solver is a **damped projected Jacobi sweep**:
  the same per-coordinate update applied to all coordinates simultaneously,
  matrix-free (``Mx = γₑAᵀ(Ax) + γᵢx`` = two ELL gather-SpMVs; ``diag(M)``
  from the squared column sums).  Everything fuses into one compiled loop.

* ``lp_admm2`` — ADMM with equalities enforced exactly in the subproblem
  (reference ``ADMM.py:272-474``; Boyd, "Distributed Optimization and
  Statistical Learning via ADMM").  The reference factorizes the KKT system
  ``[[γI, Aᵀ], [A, 0]]`` once with sparse LU (``ADMM.py:342``).  There is no
  XLA sparse LU, and none is needed: block elimination reduces the KKT solve
  to the SPD Schur complement ``(A Aᵀ) ν = A y − γ b``, which the framework
  factors ONCE as a dense Cholesky (small/medium row counts) or solves with
  matrix-free CG (large).  Per iteration the solve is two triangular
  solves — the analogue of the reference's reused LU.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ..ops.cg import conjgrad
from ..preconditioning import (
    convert_to_standard_form_with_bounds,
    precondition_constraints,
)
from ..problem import default_dtype, ell_from_scipy
from .base import (HostLoop, ToleranceStop, chunk_schedule,
                   emit_callback, to_np)


# ----------------------------------------------------------------------
# lp_admm: penalized equalities + projected Jacobi inner solver
# ----------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("nsteps", "nb_inner"))
def _admm_chunk(data, state, nsteps: int, nb_inner: int):
    a, b = data["a"], data["b"]
    c, lb, ub = data["c"], data["lb"], data["ub"]
    gamma_eq, gamma_ineq = data["gamma_eq"], data["gamma_ineq"]
    inv_diag, omega = data["inv_diag"], data["omega"]
    atb = data["atb"]

    def m_apply(v):
        return gamma_eq * a.rmatvec(a.matvec(v)) + gamma_ineq * v

    def one_iter(_, s):
        x, xp, lam_eq = s
        y = -c + gamma_eq * atb + gamma_ineq * xp - a.rmatvec(lam_eq)

        def jacobi(_, x):
            # damped projected Jacobi: parallel analogue of the reference's
            # bounded Gauss-Seidel sweep (gaussSiedel.pyx:131-152)
            x = x + omega * (y - m_apply(x)) * inv_diag
            return jnp.clip(x, lb, ub)

        x = jax.lax.fori_loop(0, nb_inner, jacobi, x)
        xp = x
        lam_eq = lam_eq + gamma_eq * (a.matvec(x) - b)
        return (x, xp, lam_eq)

    state = jax.lax.fori_loop(0, nsteps, one_iter, state)
    x, xp, lam_eq = state

    r = a.matvec(x) - b
    energy1 = (
        jnp.dot(c, x)
        + 0.5 * gamma_eq * jnp.sum(r**2)
        + jnp.dot(lam_eq, r)
    )
    metrics = dict(
        energy1=energy1,
        max_violated_equality=jnp.max(jnp.abs(r)),
        max_violated_inequality=jnp.maximum(
            jnp.max(lb - x), jnp.max(x - ub)
        ),
    )
    return state, metrics


def lp_admm(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    gamma_eq=2,
    gamma_ineq=3,
    nb_iter=100,
    callback_func=None,
    max_time=None,
    use_preconditioning=True,
    nb_iter_plot=10,
    nb_inner=2,
    omega=1.0,
    dtype=None,
    start_time=None,
    inner="jacobi",
    stop_tol=None,
    mesh=None,
    light_metrics=False,
):
    """Penalized-equality ADMM; signature parity with ``ADMM.py:47``.

    ``inner`` selects the x-subproblem solver: ``"jacobi"`` (default) is the
    fused on-device damped projected Jacobi loop; ``"gauss_seidel"`` is the
    sequential bounded Gauss-Seidel host mode (native C++ kernel,
    :mod:`pysparselp_tpu.native.gauss_seidel`) — the algorithmic twin of the
    reference's default inner solver, for parity runs on small problems.

    ``mesh`` (a 1-D ``jax.sharding.Mesh``) row-shards the constraint system:
    the Jacobi sweeps run with one ``psum`` per inner iteration
    (:mod:`pysparselp_tpu.parallel.sharded_admm`).
    """
    dtype = dtype or default_dtype()
    c = np.asarray(c, np.float64)
    n = c.size
    if x0 is None:
        x0 = np.zeros(n)
    # row-normalize before adding slacks (ADMM.py:76-83)
    if a_eq is not None and a_eq.shape[0]:
        a_eq, beq = precondition_constraints(a_eq, beq, alpha=2)
    else:
        a_eq, beq = None, None
    if a_ineq is not None and a_ineq.shape[0]:
        a_ineq, b_lower, b_upper = precondition_constraints(
            a_ineq, b_lower, b_upper, alpha=2
        )
    else:
        a_ineq = None
    c2, a, b, lb2, ub2, x02 = convert_to_standard_form_with_bounds(
        c, a_eq, beq, a_ineq, b_lower, b_upper, np.asarray(lb, float),
        np.asarray(ub, float), x0,
    )
    if use_preconditioning:
        a, b = precondition_constraints(a, b, alpha=2)

    if inner == "gauss_seidel":
        return _lp_admm_host_gs(
            c2, a, b, lb2, ub2, x02, n, gamma_eq, gamma_ineq, nb_iter,
            nb_iter_plot, nb_inner, callback_func, start_time, max_time,
            stop_tol, light_metrics,
        )

    a = scipy.sparse.csr_matrix(a)
    sq = a.copy()
    sq.data = sq.data**2
    diag_m = gamma_eq * np.asarray(sq.sum(axis=0)).ravel() + gamma_ineq

    # damped projected Jacobi converges iff omega < 2/rho(D^-1 M); estimate
    # the spectral radius once by host power iteration and clamp.  (The
    # reference's sequential Gauss-Seidel needs no damping; this is the
    # price of the parallel sweep, paid once at setup.)
    inv_diag_np = 1.0 / diag_m
    rng = np.random.RandomState(0)
    v = rng.randn(a.shape[1])
    v /= np.linalg.norm(v)
    rho = 1.0
    at = a.T.tocsr()
    for _ in range(30):
        w = inv_diag_np * (gamma_eq * (at @ (a @ v)) + gamma_ineq * v)
        nrm = np.linalg.norm(w)
        if nrm == 0:
            break
        rho = nrm
        v = w / nrm
    omega = min(float(omega), 1.8 / max(rho, 1e-12))

    common = dict(
        c=jnp.asarray(c2, dtype),
        lb=jnp.asarray(lb2, dtype),
        ub=jnp.asarray(ub2, dtype),
        gamma_eq=jnp.asarray(gamma_eq, dtype),
        gamma_ineq=jnp.asarray(gamma_ineq, dtype),
        inv_diag=jnp.asarray(1.0 / diag_m, dtype),
        omega=jnp.asarray(omega, dtype),
        atb=jnp.asarray(at @ b, dtype),
    )
    x = jnp.asarray(x02, dtype)
    xp = jnp.clip(x, common["lb"], common["ub"])

    if mesh is not None:
        from ..parallel.sharded_admm import (admm_chunk_sharded,
                                             build_sharded_system)

        sdata, rows_loc, m_pad, _ = build_sharded_system(a, b, mesh, dtype)
        ndev = m_pad // rows_loc
        data = dict(common, **sdata)
        state = {"x": x, "xp": xp,
                 "lam": jnp.zeros((ndev, rows_loc), dtype)}

        def run_chunk(state, nsteps):
            return admm_chunk_sharded(data, state, mesh, nsteps, nb_inner)

        def get_x(state):
            return state["x"]
    else:
        ell = ell_from_scipy(a, dtype=dtype)
        data = dict(common, a=ell, b=jnp.asarray(b, dtype))
        state = (x, xp, jnp.zeros(a.shape[0], dtype))

        def run_chunk(state, nsteps):
            return _admm_chunk(data, state, nsteps, nb_inner)

        def get_x(state):
            return state[0]

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    niter = 0
    for nsteps in chunk_schedule(nb_iter, nb_iter_plot):
        state, metrics = run_chunk(state, nsteps)
        niter += nsteps
        emit_callback(
            callback_func, niter, get_x(state)[:n],
            metrics["energy1"], metrics["energy1"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out or tstop.check(
            metrics["energy1"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    return to_np(get_x(state)[:n])


def _lp_admm_host_gs(c, a, b, lb, ub, x0, n, gamma_eq, gamma_ineq, nb_iter,
                     nb_iter_plot, nb_inner, callback_func, start_time,
                     max_time, stop_tol=None, light_metrics=False):
    """Host-mode ADMM iterate with the native bounded Gauss-Seidel inner
    solve — the sequential twin of the reference's default path
    (``ADMM.py:143-268`` with ``gaussSiedel.pyx:95`` inside)."""
    from ..native.gauss_seidel import BoundedGaussSeidel

    a = scipy.sparse.csr_matrix(a)
    m_mat = (
        gamma_eq * (a.T @ a) + gamma_ineq * scipy.sparse.eye(a.shape[1])
    ).tocsr()
    bs = BoundedGaussSeidel(m_mat)
    at = a.T.tocsr()
    atb = at @ b
    x = np.asarray(x0, np.float64).copy()
    xp = np.clip(x, lb, ub)
    lam = np.zeros(a.shape[0])
    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    for i in range(1, nb_iter + 1):
        y = -c + gamma_eq * atb + gamma_ineq * xp - at @ lam
        x = bs.solve(y, lb, ub, x, maxiter=max(nb_inner, 1))
        xp = x
        r = a @ x - b
        lam += gamma_eq * r
        if i % nb_iter_plot == 0 or i == nb_iter:
            energy = float(
                c @ x + 0.5 * gamma_eq * (r @ r) + lam @ r
            )
            emit_callback(
                callback_func, i, x[:n], energy, energy, lambda: loop.elapsed,
                float(np.abs(r).max(initial=0.0)),
                float(max(np.max(lb - x, initial=0.0),
                          np.max(x - ub, initial=0.0))),
                light=light_metrics,
            )
            if loop.timed_out or tstop.check(
                energy, np.abs(r).max(initial=0.0),
                max(np.max(lb - x, initial=0.0),
                    np.max(x - ub, initial=0.0)),
            ):
                break
    return x[:n]


# ----------------------------------------------------------------------
# lp_admm2: exact equality subproblem via Schur-complement Cholesky
# ----------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("nsteps", "use_dense"))
def _admm2_chunk(data, state, nsteps: int, use_dense: bool):
    a = data["a"]
    b, c = data["b"], data["c"]
    lb, ub = data["lb"], data["ub"]
    gamma, alpha = data["gamma"], data["alpha"]

    if use_dense:
        chol = data["chol"]

        def schur_solve(rhs):
            return jax.scipy.linalg.cho_solve((chol, False), rhs)
    else:
        jac = data["schur_inv_diag"]

        def schur_solve(rhs):
            return conjgrad(
                lambda v: a.matvec(a.rmatvec(v)) + data["ridge"] * v,
                rhs,
                maxiter=data_static_cg_iters,
                precond=lambda v: jac * v,
            )

    def one_iter(_, s):
        x, xp, lam, _ = s
        xp_prev = xp
        y1 = -c + gamma * xp - lam
        nu = schur_solve(a.matvec(y1) - gamma * b)
        x = (y1 - a.rmatvec(nu)) / gamma
        x = alpha * x + (1.0 - alpha) * xp
        xp = jnp.clip(x + lam / gamma, lb, ub)
        lam = lam + gamma * (x - xp)
        return (x, xp, lam, xp_prev)

    x0_, xp0_, lam0_ = state
    x, xp, lam, xp_prev = jax.lax.fori_loop(
        0, nsteps, one_iter, (x0_, xp0_, lam0_, xp0_)
    )
    state = (x, xp, lam)
    energy1 = (
        jnp.dot(c, x)
        + 0.5 * gamma * jnp.sum((x - xp) ** 2)
        + jnp.dot(lam, x - xp)
    )
    metrics = dict(
        energy1=energy1,
        max_violated_equality=jnp.max(jnp.abs(a.matvec(xp) - b)),
        max_violated_inequality=jnp.asarray(0.0, x.dtype),
        # Boyd §3.4.1 residuals for adaptive-penalty balancing
        r_primal=jnp.linalg.norm(x - xp),
        r_dual=gamma * jnp.linalg.norm(xp - xp_prev),
    )
    return state, metrics


data_static_cg_iters = 100  # CG cap for the matrix-free Schur path


def lp_admm2(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    gamma_ineq=0.7,
    nb_iter=100,
    callback_func=None,
    max_time=None,
    use_preconditioning=False,
    nb_iter_plot=10,
    alpha=1.95,
    dense_threshold=4096,
    dtype=None,
    start_time=None,
    stop_tol=None,
    adaptive_rho=False,
    mesh=None,
    light_metrics=False,
):
    """ADMM with exact equality subproblem; signature parity with ``ADMM.py:272``.

    ``adaptive_rho=True`` enables Boyd §3.4.1 residual balancing: the penalty
    doubles when the primal residual dominates the dual residual by 10x and
    halves in the opposite case, checked once per chunk.  Free here: the
    factored Schur complement ``A Aᵀ`` does not depend on the penalty.

    ``mesh`` (a 1-D ``jax.sharding.Mesh``) row-shards the constraint system:
    the Schur solve runs sharded-CG (one ``psum`` of an n-vector per CG
    step) or, in the dense-Cholesky regime, gathers the sharded rhs once
    per iteration (:mod:`pysparselp_tpu.parallel.sharded_admm`).
    """
    dtype = dtype or default_dtype()
    c = np.asarray(c, np.float64)
    n = c.size
    if x0 is None:
        x0 = np.zeros(n)
    if use_preconditioning:
        if a_eq is not None and a_eq.shape[0]:
            a_eq, beq = precondition_constraints(a_eq, beq, alpha=2)
        if a_ineq is not None and a_ineq.shape[0]:
            a_ineq, b_lower, b_upper = precondition_constraints(
                a_ineq, b_lower, b_upper, alpha=2
            )
    if a_eq is not None and a_eq.shape[0] == 0:
        a_eq, beq = None, None
    if a_ineq is not None and a_ineq.shape[0] == 0:
        a_ineq = None
    c2, a, b, lb2, ub2, x02 = convert_to_standard_form_with_bounds(
        c, a_eq, beq, a_ineq, b_lower, b_upper, np.asarray(lb, float),
        np.asarray(ub, float), x0,
    )

    m = a.shape[0]
    use_dense = m <= dense_threshold
    ridge = 1e-10 * max(1.0, float(abs(a).sum() / max(m, 1)))
    common = dict(
        c=jnp.asarray(c2, dtype),
        lb=jnp.asarray(lb2, dtype),
        ub=jnp.asarray(ub2, dtype),
        gamma=jnp.asarray(gamma_ineq, dtype),
        alpha=jnp.asarray(alpha, dtype),
        ridge=jnp.asarray(ridge, dtype),
    )
    x = jnp.asarray(x02, dtype)
    xp = jnp.clip(x, common["lb"], common["ub"])

    if mesh is not None:
        from ..parallel.sharded_admm import (admm2_chunk_sharded,
                                             build_sharded_system)

        sdata, _rows_loc, m_pad, a_pad = build_sharded_system(
            scipy.sparse.csr_matrix(a), b, mesh, dtype)
        data = dict(common, **sdata)
        if use_dense:
            s = (a_pad @ a_pad.T).toarray() + ridge * np.eye(m_pad)
            chol, _ = jax.scipy.linalg.cho_factor(
                jnp.asarray(s, dtype), lower=False)
            data["chol"] = chol
        else:
            diag_s = np.asarray(
                (a_pad.multiply(a_pad)).sum(axis=1)).ravel() + ridge
            data["schur_inv_diag"] = jnp.asarray(1.0 / diag_s, dtype)
        state = {"x": x, "xp": xp, "lam": jnp.zeros(x.shape, dtype)}

        def run_chunk(state, nsteps):
            return admm2_chunk_sharded(data, state, mesh, nsteps, use_dense)

        def get_x(state):
            return state["x"]

        def set_gamma(data, g):
            return dict(data, gamma=jnp.asarray(g, dtype))
    else:
        ell = ell_from_scipy(a, dtype=dtype)
        data = dict(common, a=ell, b=jnp.asarray(b, dtype))
        if use_dense:
            # Schur complement S = A Aᵀ (+ridge), factored once — the dense
            # analogue of the reference's one-time splu of the KKT system
            # (ADMM.py:342)
            s = (a @ a.T).toarray() + ridge * np.eye(m)
            chol, _ = jax.scipy.linalg.cho_factor(
                jnp.asarray(s, dtype), lower=False
            )
            data["chol"] = chol
        else:
            diag_s = np.asarray((a.multiply(a)).sum(axis=1)).ravel() + ridge
            data["schur_inv_diag"] = jnp.asarray(1.0 / diag_s, dtype)
        state = (x, xp, jnp.zeros(x.shape, dtype))

        def run_chunk(state, nsteps):
            return _admm2_chunk(data, state, nsteps, use_dense)

        def get_x(state):
            return state[0]

        def set_gamma(data, g):
            return dict(data, gamma=jnp.asarray(g, dtype))

    loop = HostLoop(start_time=start_time, max_time=max_time)
    tstop = ToleranceStop(stop_tol)
    gamma = float(gamma_ineq)
    niter = 0
    for nsteps in chunk_schedule(nb_iter, nb_iter_plot):
        state, metrics = run_chunk(state, nsteps)
        niter += nsteps
        if adaptive_rho:
            rp, rd = float(metrics["r_primal"]), float(metrics["r_dual"])
            if rp > 10.0 * rd and rd > 0:
                gamma *= 2.0
                data = set_gamma(data, gamma)
            elif rd > 10.0 * rp and rp > 0:
                gamma *= 0.5
                data = set_gamma(data, gamma)
        emit_callback(
            callback_func, niter, get_x(state)[:n],
            metrics["energy1"], metrics["energy1"], lambda: loop.elapsed,
            metrics["max_violated_equality"], metrics["max_violated_inequality"],
            light=light_metrics,
        )
        if loop.timed_out or tstop.check(
            metrics["energy1"], metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
        ):
            break
    return to_np(get_x(state)[:n])
