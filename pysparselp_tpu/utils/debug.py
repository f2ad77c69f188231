"""Numerical-sanity debug mode.

The reference's single-threaded design needs no race detection; its sanity
layer is asserts sprinkled through the code (``check_csr_matrix``
``SparseLP.py:86-91``, pyamg level finiteness ``ADMM.py:388-390``,
``CheckDecrease`` ``tools.py:47-59``).  The device equivalent (SURVEY.md §5) is
JAX's traced-computation checks: NaN trapping inside jitted loops plus
host-side finiteness asserts at chunk boundaries.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def debug_mode(nans=True, infs=False):
    """Enable jax NaN/Inf trapping inside jitted solver loops.

    NaN checks force a sync after each op and disable some fusions — debug
    only, never in production runs.
    """
    import jax

    prev_nan = jax.config.jax_debug_nans
    prev_inf = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)
        jax.config.update("jax_debug_infs", prev_inf)


def assert_all_finite(name, *arrays):
    """Host-side chunk-boundary check (cheap: state is already fetched)."""
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.all(np.isfinite(a)):
            bad = np.count_nonzero(~np.isfinite(a))
            raise FloatingPointError(
                f"{name}: array {i} has {bad}/{a.size} non-finite entries"
            )
