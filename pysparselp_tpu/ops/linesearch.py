"""Exact line search for LP dual ascent, as sort + cumsum.

The dual of a box-constrained LP along a ray ``y + α g`` is a piecewise-linear
concave function of α; its breakpoints are where a reduced cost
``c̄_k + α (gᵀA)_k`` changes sign.  The reference computes the exact maximizer
by sorting breakpoints and accumulating derivative pieces
(``pysparselp/DualGradientAscent.py:36-65`` and the per-row variant
``DualCoordinateAscent.py:139-165``).  That machinery is a perfect fit for
the device: one ``jnp.sort``/``argsort`` + two ``cumsum`` + a
``searchsorted``, all data-parallel, with masking replacing the reference's sparse-index filtering.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exact_dual_line_search(da, db, c_bar, upper_bounds, lower_bounds, tie_t=0.5):
    """Maximizing step α* of the LP dual along a direction.

    Args:
      da: ``gᵀA`` — change of the reduced costs per unit step (any size; zero
        entries are masked out like the reference's sparse-only iteration).
      db: ``gᵀb`` — scalar change of the linear dual term.
      c_bar: current reduced costs, same size as ``da``.
      upper_bounds / lower_bounds: variable box bounds (may be ±inf).
      tie_t: interpolation factor used when the derivative is exactly 0 on a
        breakpoint interval (the reference draws it uniformly at random,
        ``DualGradientAscent.py:57-61``); pass a traced uniform sample for
        faithful tie randomization.

    Returns α* (may be +inf if the dual is unbounded along the ray — callers
    clamp with a max-step, as the reference does for the y≥0 constraint).
    """
    mask = da != 0
    big = jnp.asarray(jnp.inf, da.dtype)
    alphas = jnp.where(mask, -c_bar / jnp.where(mask, da, 1.0), big)
    dau = jnp.where(mask, da * upper_bounds, 0.0)
    dal = jnp.where(mask, da * lower_bounds, 0.0)
    lo = jnp.minimum(dau, dal)
    hi = jnp.maximum(dau, dal)

    order = jnp.argsort(alphas)
    lo_s = jnp.take(lo, order)
    hi_s = jnp.take(hi, order)

    n = da.shape[0]
    # derivative of the dual on each of the n+1 breakpoint intervals:
    # derivs[j] = -db + sum_{k >= j} hi_s[k] + sum_{k < j} lo_s[k]
    suffix_hi = jnp.concatenate(
        [jnp.cumsum(hi_s[::-1])[::-1], jnp.zeros(1, da.dtype)]
    )
    prefix_lo = jnp.concatenate([jnp.zeros(1, da.dtype), jnp.cumsum(lo_s)])
    derivs = -db + suffix_hi + prefix_lo

    # concave => derivs non-increasing; first interval with deriv <= 0
    k = jnp.searchsorted(-derivs, 0.0)
    k = jnp.clip(k, 1, n)
    alpha_lo = alphas[order[k - 1]]
    alpha_hi = alphas[order[jnp.minimum(k, n - 1)]]
    tie = (jnp.take(derivs, k) == 0) & (k < n) & jnp.isfinite(alpha_hi)
    alpha = jnp.where(tie, tie_t * alpha_hi + (1.0 - tie_t) * alpha_lo, alpha_lo)
    return alpha
