"""Batched LP serving: many variants of ONE constraint matrix per solve.

A common production pattern is a stream of LPs that share their constraint
matrix and differ only in the cost vector, right-hand sides, or variable
bounds (per-frame segmentation energies, per-request resource allocations,
scenario sweeps).  The reference has no batched path — every variant pays a
full ``SparseLP.solve`` scipy loop (``pysparselp/SparseLP.py:990``).

Design: the CP-PPD iteration (`solvers.chambolle_pock.cp_chunk_impl`) is a
pure function of a pytree-registered
:class:`~pysparselp_tpu.problem.LPProblem`, so a batch is ONE ``jax.vmap``
over exactly the fields that vary — the operators and the diagonal
preconditioners (which depend only on the matrix) stay unbatched and are
built once.  With the dense operator backend the batched iteration is a
pair of ``(B, n) x (n, m)`` matmuls per step; larger systems use the
gather-free partition operator for assignment rows, the shift DIA for
banded systems, column-split composites of those for
``[structured | hot-columns]`` shapes, else gather-ELL.  The whole chunk
loop runs in one jitted dispatch per checkpoint.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from .problem import (DENSE_AUTO_MAX_ENTRIES, DIA_AUTO_MAX_OFFSETS,
                      DenseMatrix, DiaMatrix, EllMatrix, LPProblem,
                      dia_offset_count)
from .solvers.chambolle_pock import (_fold_one_sided, cp_chunk_impl,
                                     host_preconditioners)


def _lower_xla(a, dtype, _split=True):
    """Lower to a vmappable operator: dense (matmuls for the whole batch)
    when the dense form is affordable; the gather-free partition operator
    for assignment/simplex row patterns; the shift DIA for banded systems;
    a column-split composite of those blocks for ``[structured |
    hot-columns]`` shapes (the k-medians inequality system); else plain
    ELL."""
    from .problem import (ColBlockMatrix, PartitionMatrix, col_split_plan,
                          partition_geometry)

    csr = scipy.sparse.csr_matrix(a)
    m, n = csr.shape
    if m * n <= DENSE_AUTO_MAX_ENTRIES:
        return DenseMatrix(a=jnp.asarray(csr.toarray(), dtype), nrows=m,
                           ncols=n)
    if partition_geometry(csr) is not None:
        return PartitionMatrix.from_scipy(csr, dtype=dtype)
    if dia_offset_count(csr) <= DIA_AUTO_MAX_OFFSETS:
        return DiaMatrix.from_scipy(csr, dtype=dtype)
    if _split:
        _, cuts = col_split_plan(csr, dtype)
        if cuts:
            csc = csr.tocsc()
            starts = (0,) + tuple(cuts) + (n,)
            blocks = tuple(
                _lower_xla(csc[:, starts[b]:starts[b + 1]].tocsr(), dtype,
                           _split=False)
                for b in range(len(starts) - 1))
            return ColBlockMatrix(blocks=blocks, col_starts=starts,
                                  nrows=m, ncols=n)
    return EllMatrix.from_scipy(csr, dtype=dtype)


@functools.partial(jax.jit, static_argnames=("nsteps", "axes"))
def _batched_chunk(prob, pre, state, nsteps, axes):
    """One vmapped chunk: ``axes`` is the hashable LPProblem axis spec
    (0 = batched field, None = shared), built by :func:`solve_cp_batch`."""
    prob_ax = LPProblem(
        c=axes[0], lb=axes[1], ub=axes[2],
        a_eq=None, b_eq=axes[3], a_ineq=None, b_lower=None,
        b_upper=axes[4], n=prob.n, m_eq=prob.m_eq, m_ineq=prob.m_ineq)
    return jax.vmap(
        lambda p, s: cp_chunk_impl(p, pre, s, nsteps),
        in_axes=(prob_ax, 0),
    )(prob, state)


def solve_cp_batch(lp, costs=None, b_eq=None, b_lower=None, b_upper=None,
                   lb=None, ub=None, nb_iter=1000, nb_iter_plot=None,
                   dtype=None, alpha=1.0, theta=1.0, x0=None):
    """Solve ``B`` variants of ``lp`` that share its constraint MATRIX.

    Any of ``costs``/``b_eq``/``b_lower``/``b_upper``/``lb``/``ub`` may be
    a ``(B, ...)`` batch (the others default to the template values from
    ``lp``); all provided batches must agree on ``B``.  Preconditioners
    and operator lowering are computed once from the matrix; the batch
    advances in lock-step vmapped CP-PPD iterations (the trajectory of
    each element equals the single-problem per-op solver's on the same
    operator backend).  Reference iteration being batched:
    ``pysparselp/ChambollePockPPD.py:199-240``.

    Returns ``(X, info)``: ``X`` is the ``(B, n)`` solution array and
    ``info`` a dict with the operator ``backend`` and per-checkpoint
    batched curves (``itrn`` ``(P,)``; ``energy1``, ``energy2``,
    ``max_violated_equality``, ``max_violated_inequality`` all ``(P, B)``).
    """
    from .problem import default_dtype
    from .solvers import _csr_with_blocks

    dtype = dtype or default_dtype()
    a_eq, _ = _csr_with_blocks(lp.a_equalities)
    a_ineq_raw, _ = _csr_with_blocks(lp.a_inequalities)
    a_one, b_one = _fold_one_sided(a_ineq_raw, lp.b_lower, lp.b_upper)
    if a_one is not None and a_one.shape[0] == 0:
        a_one, b_one = None, None
    if a_eq is None and a_one is None:
        raise ValueError("solve_cp_batch needs at least one constraint "
                         "system")

    n = lp.nb_variables
    batched = [np.asarray(v) for v in
               (costs, b_eq, b_lower, b_upper, lb, ub) if v is not None]
    if not batched:
        raise ValueError("pass at least one batched input (costs, b_eq, "
                         "b_lower, b_upper, lb or ub)")
    bs = {v.shape[0] for v in batched if v.ndim == 2}
    if len(bs) > 1:
        raise ValueError(f"inconsistent batch sizes: {sorted(bs)}")
    bsz = bs.pop() if bs else 1

    def pick(v, template, size, name):
        """Batched (B, size) array from the override or the template."""
        if v is None:
            base = np.zeros(size) if template is None else np.asarray(
                template, np.float64)
            return np.broadcast_to(base, (bsz, size)), False
        v = np.asarray(v, np.float64)
        if v.ndim == 1:
            v = np.broadcast_to(v, (bsz, size))
        if v.shape != (bsz, size):
            raise ValueError(f"{name} batch must be (B, {size}), got "
                             f"{v.shape}")
        return v, True

    c_b, c_v = pick(costs, lp.costsvector, n, "costs")
    lb_b, lb_v = pick(lb, lp.lower_bounds, n, "lb")
    ub_b, ub_v = pick(ub, lp.upper_bounds, n, "ub")
    beq_b = beq_v = None
    if a_eq is not None:
        beq_b, beq_v = pick(b_eq, lp.b_equalities, a_eq.shape[0], "b_eq")
    elif b_eq is not None:
        raise ValueError("b_eq batch given but the LP has no equalities")
    bineq_b = bineq_v = None
    if a_one is not None:
        # the one-sided fold keeps b' = [bu[keep_u]; -bl[keep_l]] — apply
        # the same static row selection to the batched sides
        if b_lower is not None or b_upper is not None:
            bl_t = lp.b_lower
            bu_t = lp.b_upper
            bl_b, _ = pick(b_lower, bl_t, a_ineq_raw.shape[0],
                           "b_lower")
            bu_b, _ = pick(b_upper, bu_t, a_ineq_raw.shape[0],
                           "b_upper")
            if bl_t is None:
                bineq_b = bu_b
            else:
                keep_u = np.nonzero(bu_t != np.inf)[0]
                keep_l = np.nonzero(bl_t != -np.inf)[0]
                bineq_b = np.concatenate(
                    (bu_b[:, keep_u], -bl_b[:, keep_l]), axis=1)
            bineq_v = True
        else:
            bineq_b = np.broadcast_to(np.asarray(b_one, np.float64),
                                      (bsz, b_one.size))
            bineq_v = False
    elif b_lower is not None or b_upper is not None:
        raise ValueError("b_lower/b_upper batch given but the LP has no "
                         "inequalities")

    eq_m = _lower_xla(a_eq, dtype) if a_eq is not None else None
    in_m = _lower_xla(a_one, dtype) if a_one is not None else None
    backend = {
        "eq": type(eq_m).__name__ if eq_m is not None else None,
        "ineq": type(in_m).__name__ if in_m is not None else None,
    }

    # diagonal preconditioners from the SHARED matrix
    diag_t, sig_eq, sig_in = host_preconditioners(a_eq, a_one, alpha)
    pre = {"theta": jnp.asarray(theta, dtype),
           "diag_t": jnp.asarray(diag_t, dtype)}
    if sig_eq is not None:
        pre["sigma_eq"] = jnp.asarray(sig_eq, dtype)
    if sig_in is not None:
        pre["sigma_ineq"] = jnp.asarray(sig_in, dtype)

    def dev(v):
        return jnp.asarray(v, dtype)

    # batched problem pytree: vmapped fields carry the (B, ...) axis, the
    # operators/preconditioners broadcast.  ``axes`` mirrors it (hashable
    # tuple -> one compiled chunk per axis pattern, not per batch value)
    m_eq = eq_m.nrows if eq_m is not None else 0
    m_in = in_m.nrows if in_m is not None else 0
    prob = LPProblem(
        c=dev(c_b if c_v else c_b[0]),
        lb=dev(lb_b if lb_v else lb_b[0]),
        ub=dev(ub_b if ub_v else ub_b[0]),
        a_eq=eq_m,
        b_eq=(dev(beq_b if beq_v else beq_b[0])
              if a_eq is not None else None),
        a_ineq=in_m, b_lower=None,
        b_upper=(dev(bineq_b if bineq_v else bineq_b[0])
                 if a_one is not None else None),
        n=n, m_eq=m_eq, m_ineq=m_in)
    axes = (0 if c_v else None, 0 if lb_v else None, 0 if ub_v else None,
            (0 if beq_v else None) if a_eq is not None else None,
            (0 if bineq_v else None) if a_one is not None else None)

    if x0 is None:
        x_b = np.zeros((bsz, n))
    else:
        x0 = np.asarray(x0, np.float64)
        x_b = np.broadcast_to(x0, (bsz, n)).copy()
    state = (dev(x_b), dev(x_b),
             jnp.zeros((bsz, m_eq), dtype), jnp.zeros((bsz, m_in), dtype))

    nb_iter_plot = nb_iter_plot or nb_iter
    curves = {k: [] for k in ("energy1", "energy2",
                              "max_violated_equality",
                              "max_violated_inequality")}
    itrn = []
    done = 0
    metrics = None
    while done < nb_iter:
        target = min(done + nb_iter_plot, nb_iter)
        state, metrics = _batched_chunk(prob, pre, state, target - done,
                                        axes)
        done = target
        itrn.append(done)
        # ONE device fetch per checkpoint: stack the four (B,) metric
        # vectors
        stacked = np.asarray(jnp.stack([metrics[k] for k in curves]),
                             np.float64)
        for i, k in enumerate(curves):
            curves[k].append(stacked[i])
    info = {"backend": backend, "itrn": np.asarray(itrn)}
    info.update({k: np.stack(v) for k, v in curves.items()})
    return np.asarray(state[0], np.float64), info
