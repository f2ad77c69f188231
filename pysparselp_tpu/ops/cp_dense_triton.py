"""Whole-chunk CP-PPD kernel for small dense LPs (Pallas, Triton route).

Netlib-class LPs (SC105: 105 rows) lower both constraint systems to
:class:`~pysparselp_tpu.problem.DenseMatrix`.  On the XLA path every CP
iteration is a dozen tiny kernels plus a while-loop step, so the time per
iteration is launch cost, not bytes.  This kernel runs a whole chunk of
iterations in ONE single-program launch:

    d  = c + A_eᵀ y_e + A_iᵀ y_i          (reductions over the row axis)
    x2 = clip(x − T∘d, l, u);  x3 = (1+θ)x2 − θx;  x = x2
    y_e = y_e + σ_e∘(A_e x3 − b_e)         (reductions over the column axis)
    y_i = max(y_i + σ_i∘(A_i x3 − b_i), 0)

Both dense systems are loaded once and stay on chip for the whole chunk;
both SpMV directions are reductions over the same tile (axis 0 or 1), so
no transposed copy exists.  With ``with_sums`` the kernel also returns the
running sums of ``x``, ``y_e`` and ``y_i`` the restart-to-average controller
consumes.  Shapes are zero-padded to powers of two (padded columns have
``l = u = 0``, padded rows zero coefficients and zero steps, so they stay
at zero).

The kernel only runs compiled on a GPU (``backend="triton"``); elsewhere
it runs only when asked for the Pallas interpreter (``interpret=True``, the
CPU tests).  Reference context: the hot loop of
``pysparselp/ChambollePockPPD.py:195-342``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# padded entries of both systems together: SC105 (two 128x128 blocks)
# fits with room for one 256x256 system
DENSE_FUSED_MAX_ENTRIES = 1 << 16


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def padded_shapes(prob):
    """``(n_pad, m_eq_pad, m_in_pad)``: power-of-two sizes (0 = absent)."""
    n_pad = _pow2(prob.n)
    me = _pow2(prob.m_eq) if prob.a_eq is not None else 0
    mi = _pow2(prob.m_ineq) if prob.a_ineq is not None else 0
    return n_pad, me, mi


def cp_dense_fused_eligible(prob) -> bool:
    """Shape gate: every present system is an f32 DenseMatrix and the
    padded systems together hold at most ``DENSE_FUSED_MAX_ENTRIES``."""
    from ..problem import DenseMatrix

    ops = [op for op in (prob.a_eq, prob.a_ineq) if op is not None]
    if not ops:
        return False
    if not all(isinstance(op, DenseMatrix) and op.a.dtype == jnp.float32
               for op in ops):
        return False
    n_pad, me, mi = padded_shapes(prob)
    return n_pad * (me + mi) <= DENSE_FUSED_MAX_ENTRIES


def _num_warps(entries: int) -> int:
    # enough threads that the register-resident tiles stay within ~64
    # registers a thread
    return int(min(16, max(4, entries // 2048)))


def _make_kernel(has_eq, has_in, nsteps, theta, with_sums):
    def kernel(*refs):
        it = iter(refs)
        c_ref, dt_ref, lb_ref, ub_ref = (next(it) for _ in range(4))
        if has_eq:
            ae_ref, be_ref, se_ref = (next(it) for _ in range(3))
        if has_in:
            ai_ref, bi_ref, si_ref = (next(it) for _ in range(3))
        x_ref = next(it)
        ye_ref = next(it) if has_eq else None
        yi_ref = next(it) if has_in else None
        outs = list(it)

        c, dt, lb, ub = c_ref[...], dt_ref[...], lb_ref[...], ub_ref[...]
        if has_eq:
            ae, be, se = ae_ref[...], be_ref[...], se_ref[...]
        if has_in:
            ai, bi, si = ai_ref[...], bi_ref[...], si_ref[...]

        def body(_, carry):
            x, ye, yi, _x3, sx, se_sum, si_sum = carry
            d = c
            if has_eq:
                d = d + jnp.sum(ae * ye[:, None], axis=0)
            if has_in:
                d = d + jnp.sum(ai * yi[:, None], axis=0)
            x2 = jnp.minimum(jnp.maximum(x - dt * d, lb), ub)
            x3 = (1.0 + theta) * x2 - theta * x
            if has_eq:
                ye = ye + se * (jnp.sum(ae * x3[None, :], axis=1) - be)
            if has_in:
                yi = jnp.maximum(
                    yi + si * (jnp.sum(ai * x3[None, :], axis=1) - bi), 0.0)
            if with_sums:
                sx = sx + x2
                if has_eq:
                    se_sum = se_sum + ye
                if has_in:
                    si_sum = si_sum + yi
            return x2, ye, yi, x3, sx, se_sum, si_sum

        x0 = x_ref[...]
        zero = jnp.zeros((1,), jnp.float32)
        ye0 = ye_ref[...] if has_eq else zero
        yi0 = yi_ref[...] if has_in else zero
        carry = (x0, ye0, yi0, x0, jnp.zeros_like(x0), jnp.zeros_like(ye0),
                 jnp.zeros_like(yi0))
        x, ye, yi, x3, sx, se_sum, si_sum = jax.lax.fori_loop(
            0, nsteps, body, carry)

        res = [x, x3]
        if has_eq:
            res.append(ye)
        if has_in:
            res.append(yi)
        if with_sums:
            res.append(sx)
            if has_eq:
                res.append(se_sum)
            if has_in:
                res.append(si_sum)
        for ref, v in zip(outs, res):
            ref[...] = v

    return kernel


@functools.partial(jax.jit, static_argnames=("nsteps", "theta_f",
                                             "interpret", "with_sums"))
def cp_dense_fused_call(prob, pre, x, y_eq, y_in, nsteps, theta_f,
                        interpret=False, with_sums=False):
    """``nsteps`` CP iterations in one kernel launch.  Returns
    ``(x, x3, y_eq, y_ineq)`` and, with ``with_sums``, the running sums
    ``(Σx, Σy_eq, Σy_ineq)`` (empty arrays for absent systems)."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the dense Triton CP kernel compiles only for a GPU; pass "
            "interpret=True to run it in the Pallas interpreter")
    has_eq = prob.a_eq is not None
    has_in = prob.a_ineq is not None
    n = prob.n
    n_pad, me, mi = padded_shapes(prob)
    f32 = jnp.float32

    def vec(v, size, pad):
        return jnp.zeros((pad,), f32).at[:size].set(v.astype(f32))

    def mat(op, m_pad):
        return jnp.zeros((m_pad, n_pad), f32).at[:op.nrows, :n].set(
            op.a.astype(f32))

    inputs = [vec(prob.c, n, n_pad), vec(pre["diag_t"], n, n_pad),
              vec(prob.lb, n, n_pad), vec(prob.ub, n, n_pad)]
    if has_eq:
        inputs += [mat(prob.a_eq, me), vec(prob.b_eq, prob.m_eq, me),
                   vec(pre["sigma_eq"], prob.m_eq, me)]
    if has_in:
        inputs += [mat(prob.a_ineq, mi), vec(prob.b_upper, prob.m_ineq, mi),
                   vec(pre["sigma_ineq"], prob.m_ineq, mi)]
    inputs.append(vec(x, n, n_pad))
    if has_eq:
        inputs.append(vec(y_eq, prob.m_eq, me))
    if has_in:
        inputs.append(vec(y_in, prob.m_ineq, mi))

    shapes = [n_pad, n_pad] + [m for m in (me, mi) if m]
    if with_sums:
        shapes += [n_pad] + [m for m in (me, mi) if m]
    out_shape = [jax.ShapeDtypeStruct((s,), f32) for s in shapes]
    outs = pl.pallas_call(
        _make_kernel(has_eq, has_in, nsteps, float(theta_f), with_sums),
        out_shape=out_shape,
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(n_pad * (me + mi)), num_stages=1),
        name="cp_dense_chunk",
    )(*inputs)

    dt = x.dtype
    it = iter(outs)

    def take(size, present=True):
        return next(it)[:size].astype(dt) if present else jnp.zeros(0, dt)

    res = (take(n), take(n), take(prob.m_eq, has_eq),
           take(prob.m_ineq, has_in))
    if with_sums:
        res += (take(n), take(prob.m_eq, has_eq), take(prob.m_ineq, has_in))
    return res


def cp_dense_fused_chunk(prob, pre, state, nsteps: int, theta: float,
                         interpret=False):
    """Run ``nsteps`` fused iterations on a ``(x, x3, y_eq, y_ineq)`` state."""
    x, _x3, y_eq, y_ineq = state
    return cp_dense_fused_call(prob, pre, x, y_eq, y_ineq, nsteps,
                               float(theta), interpret=interpret)
