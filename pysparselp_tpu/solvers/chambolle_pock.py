"""Diagonally-preconditioned Chambolle–Pock primal-dual LP solver in JAX.

Same algorithm as the reference's flagship first-order solver
(``pysparselp/ChambollePockPPD.py:36-346``; Pock & Chambolle, ICCV'11
"Diagonal preconditioning for first order primal-dual algorithms"), rebuilt
for an accelerator: the hot loop — two transpose-SpMVs, a box-projected
primal step, over-relaxation, two SpMVs and the dual ascent — is a single
``lax.fori_loop`` body compiled once per problem shape.  SpMVs run on the
auto-selected operator backend (:func:`~pysparselp_tpu.problem.ell_from_scipy`:
dense / DIA shifts / partition / block-ELL / column-split composites /
gather-ELL); metrics are evaluated on device once per ``nb_iter_plot``
chunk.  Small dense LPs on a GPU run whole chunks in one Pallas kernel
(:mod:`~pysparselp_tpu.ops.cp_dense_triton`).

Beyond the reference, an opt-in PDLP-style acceleration (primal weight +
adaptive restart-to-average, Applegate et al. 2021) runs as a
device-resident controller — see :func:`_cp_chunk_restart_device`.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ..problem import (DENSE_SMALL_MAX_ENTRIES, DIA_AUTO_MAX_OFFSETS,
                       LPProblem, aligned_offset_count, anchor_align,
                       apply_align_embedding, apply_rcm_permutation,
                       default_dtype, effective_stream_bytes, ell_from_scipy,
                       embed_matrix, rcm_permutation)
from ..ops.cp_dense_triton import (cp_dense_fused_call,
                                   cp_dense_fused_chunk,
                                   cp_dense_fused_eligible)
from .base import HostLoop, chunk_schedule, emit_callback, to_np

# what the last single-device solve ran: the layout presolve's choice, the
# operator backend of each system and whether the fused dense kernel ran
last_plan = None


def _fold_one_sided(a_ineq, b_lower, b_upper):
    """Fold ``bl <= Ax <= bu`` into ``A'x <= b'`` dropping infinite sides
    (mirrors ``ChambollePockPPD.py:74-88``)."""
    if a_ineq is None:
        return None, None
    a_ineq = scipy.sparse.csr_matrix(a_ineq)
    if b_lower is None:
        return a_ineq, np.asarray(b_upper, np.float64)
    keep_u = np.nonzero(b_upper != np.inf)[0]
    keep_l = np.nonzero(b_lower != -np.inf)[0]
    if keep_u.size and keep_l.size:
        a = scipy.sparse.vstack((a_ineq[keep_u, :], -a_ineq[keep_l, :])).tocsr()
    elif keep_l.size:
        a = (-a_ineq).tocsr()[keep_l, :]
    else:
        a = a_ineq[keep_u, :]
    b = np.concatenate((b_upper[keep_u], -b_lower[keep_l]))
    return a, b


def host_preconditioners(a_eq, a_ineq, alpha=1.0, omega=1.0):
    """Diagonal CP preconditioners from host scipy matrices (the driver's
    formulas, ``ChambollePockPPD.py:122-179``):
    ``T_jj = omega / sum_i |a_ij|^(2-alpha)``,
    ``Sigma_ii = 1 / (omega * sum_j |a_ij|^alpha)`` per system.
    Returns ``(diag_t, sigma_eq, sigma_ineq)`` numpy arrays (sigmas are
    ``None`` for absent systems).  Shared by the batched and the
    row-sharded builders — the device driver computes the same
    quantities with operator ops."""
    n = (a_eq if a_eq is not None else a_ineq).shape[1]
    col_sum = np.zeros(n)
    sigmas = []
    for a in (a_eq, a_ineq):
        if a is None:
            sigmas.append(None)
            continue
        aa = scipy.sparse.csr_matrix(a).copy()
        aa.data = np.abs(aa.data) ** (2.0 - alpha)
        col_sum += np.asarray(aa.sum(axis=0)).ravel()
        ab = scipy.sparse.csr_matrix(a).copy()
        ab.data = np.abs(ab.data) ** alpha
        rs = np.asarray(ab.sum(axis=1)).ravel()
        rs[rs == 0] = 1.0
        sigmas.append(1.0 / (rs * omega))
    col_sum[col_sum == 0] = 1.0
    return omega / col_sum, sigmas[0], sigmas[1]


def _cp_iteration(prob: LPProblem, pre, s):
    """One CP-PPD iteration (primal prox + over-relaxation + dual ascent)."""
    theta = pre["theta"]
    x, x3, y_eq, y_ineq = s
    d = prob.c
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
    x2 = jnp.clip(x - pre["diag_t"] * d, prob.lb, prob.ub)
    x3 = (1.0 + theta) * x2 - theta * x
    x = x2
    if prob.a_eq is not None:
        r_eq = prob.a_eq.matvec(x3) - prob.b_eq
        y_eq = y_eq + pre["sigma_eq"] * r_eq
    if prob.a_ineq is not None:
        r_ineq = prob.a_ineq.matvec(x3) - prob.b_upper
        y_ineq = jnp.maximum(y_ineq + pre["sigma_ineq"] * r_ineq, 0.0)
    return (x, x3, y_eq, y_ineq)


def cp_chunk_impl(prob: LPProblem, pre, state, nsteps: int):
    """Run ``nsteps`` CP-PPD iterations then evaluate metrics on device.

    Pure function (jitted as ``_cp_chunk``); also the compile-check entry
    point exposed through ``__graft_entry__.entry``.
    """
    state = jax.lax.fori_loop(
        0, nsteps, lambda _, s: _cp_iteration(prob, pre, s), state
    )
    x, x3, y_eq, y_ineq = state

    # -- metrics (``ChambollePockPPD.py:242-315``) ------------------------
    d = prob.c
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
    # dual-feasible primal minimizer for the lower bound (energy2)
    x4 = jnp.where(d < 0, prob.ub, prob.lb)
    energy1 = jnp.dot(prob.c, x)
    energy2 = jnp.dot(prob.c, x4)
    max_v_eq = jnp.asarray(0.0, x.dtype)
    max_v_ineq = jnp.asarray(0.0, x.dtype)
    x_rounded = jnp.round(x)
    energy_rounded = jnp.dot(prob.c, x_rounded)
    rounded_feasible = jnp.asarray(True)
    if prob.a_eq is not None:
        r_eq = prob.a_eq.matvec(x) - prob.b_eq
        energy1 = energy1 + jnp.dot(y_eq, r_eq)
        energy2 = energy2 + jnp.dot(y_eq, prob.a_eq.matvec(x4) - prob.b_eq)
        max_v_eq = jnp.max(jnp.abs(r_eq))
        rounded_feasible &= jnp.max(
            jnp.abs(prob.a_eq.matvec(x_rounded) - prob.b_eq)
        ) == 0
    if prob.a_ineq is not None:
        r_ineq = prob.a_ineq.matvec(x) - prob.b_upper
        energy1 = energy1 + jnp.dot(y_ineq, r_ineq)
        energy2 = energy2 + jnp.dot(y_ineq, prob.a_ineq.matvec(x4) - prob.b_upper)
        max_v_ineq = jnp.max(r_ineq)
        rounded_feasible &= jnp.max(
            prob.a_ineq.matvec(x_rounded) - prob.b_upper
        ) <= 0
    metrics = dict(
        energy1=energy1,
        energy2=energy2,
        max_violated_equality=max_v_eq,
        max_violated_inequality=max_v_ineq,
        energy_rounded=energy_rounded,
        rounded_feasible=rounded_feasible,
    )
    return state, metrics


_cp_chunk = functools.partial(jax.jit, static_argnames=("nsteps",))(cp_chunk_impl)


def _scale_pre(pre, omega):
    """Apply the primal weight to the diagonal step sizes (τσ invariant)."""
    out = dict(pre)
    out["diag_t"] = pre["diag_t"] * omega
    if "sigma_eq" in pre:
        out["sigma_eq"] = pre["sigma_eq"] / omega
    if "sigma_ineq" in pre:
        out["sigma_ineq"] = pre["sigma_ineq"] / omega
    return out


@functools.partial(jax.jit, static_argnames=("nsteps", "period",
                                             "use_fused", "theta_f",
                                             "interpret"))
def _cp_chunk_restart_device(prob: LPProblem, pre_base, rstate, nsteps: int,
                             period: int, use_fused=None,
                             theta_f: float = 1.0, interpret=False):
    """Device-resident restart controller: runs ``nsteps`` iterations with a
    PDLP restart check every ``period`` iterations entirely on device (one
    dispatch per chunk, no host synchronization for scores or the
    primal-weight update).  ``rstate`` carries the solver state plus the
    controller scalars (ω, score at last restart, last candidate score) and
    the last restart point.  ``use_fused="dense"`` runs each period in the
    dense Triton kernel (``interpret`` selects the Pallas interpreter)."""
    beta_suf, beta_nec = 0.2, 0.8
    nblocks = max(nsteps // period, 0)
    rem = nsteps - nblocks * period

    def run_block(rs):
        state = rs["state"]
        pre = _scale_pre(pre_base, rs["omega"])
        if use_fused == "dense":
            # whole-period dense kernel (ops/cp_dense_triton): iterations
            # that also accumulate the running sums the controller consumes
            x_n, x3_n, ye_n, yi_n, sx, se, si = cp_dense_fused_call(
                prob, pre, state[0], state[2], state[3], period, theta_f,
                interpret=interpret, with_sums=True)
            state = (x_n, x3_n, ye_n, yi_n)
        else:
            sums = (jnp.zeros_like(state[0]), jnp.zeros_like(state[2]),
                    jnp.zeros_like(state[3]))

            def body(_, carry):
                s, (sx, se, si) = carry
                s = _cp_iteration(prob, pre, s)
                return s, (sx + s[0], se + s[2], si + s[3])

            (state, (sx, se, si)) = jax.lax.fori_loop(0, period, body,
                                                      (state, sums))
        inv = 1.0 / period
        avg = (sx * inv, se * inv, si * inv)
        s_cur = _kkt_score(prob, state[0], state[2], state[3])
        s_avg = _kkt_score(prob, *avg)
        mu_c = jnp.minimum(s_cur, s_avg)
        do = (mu_c <= beta_suf * rs["mu_restart"]) | (
            (mu_c <= beta_nec * rs["mu_restart"]) & (mu_c > rs["mu_last"])
        )
        use_avg = s_avg < s_cur
        zx = jnp.where(use_avg, avg[0], state[0])
        zeq = jnp.where(use_avg, avg[1], state[2])
        zineq = jnp.where(use_avg, avg[2], state[3])
        dx = jnp.linalg.norm(zx - rs["zx"])
        dy = jnp.sqrt(jnp.sum((zeq - rs["zeq"]) ** 2)
                      + jnp.sum((zineq - rs["zineq"]) ** 2))
        valid = (dx > 1e-30) & (dy > 1e-30)
        # ω here is the PRIMAL weight (diag_t scales with ω), so the PDLP
        # movement update uses Δx/Δy: when the primal iterate moves farther
        # than the dual, primal steps should grow
        om_new = jnp.where(
            do & valid,
            jnp.exp(0.5 * jnp.log(dx / jnp.maximum(dy, 1e-30))
                    + 0.5 * jnp.log(rs["omega"])),
            rs["omega"],
        )
        new_state = (
            jnp.where(do, zx, state[0]),
            jnp.where(do, zx, state[1]),
            jnp.where(do, zeq, state[2]),
            jnp.where(do, zineq, state[3]),
        )
        return {
            "state": new_state,
            "omega": om_new,
            "mu_restart": jnp.where(do, mu_c, rs["mu_restart"]),
            "mu_last": jnp.where(do, jnp.asarray(jnp.inf, mu_c.dtype),
                                 mu_c),
            "zx": jnp.where(do, zx, rs["zx"]),
            "zeq": jnp.where(do, zeq, rs["zeq"]),
            "zineq": jnp.where(do, zineq, rs["zineq"]),
        }

    rstate = jax.lax.fori_loop(0, nblocks, lambda _, rs: run_block(rs),
                               rstate)
    if rem:
        pre = _scale_pre(pre_base, rstate["omega"])
        if use_fused == "dense":
            s = rstate["state"]
            state = cp_dense_fused_call(prob, pre, s[0], s[2], s[3], rem,
                                        theta_f, interpret=interpret)
        else:
            state = jax.lax.fori_loop(
                0, rem, lambda _, s: _cp_iteration(prob, pre, s),
                rstate["state"])
        rstate = dict(rstate, state=state)
    _, metrics = cp_chunk_impl(prob, _scale_pre(pre_base, rstate["omega"]),
                               rstate["state"], 0)
    return rstate, metrics


def estimate_omega(c, beq=None, b_ineq=None):
    """Primal-weight estimate: ratio of the primal scale (finite nonzero rhs
    magnitudes) to the dual scale (nonzero cost magnitudes)."""
    prim = []
    if beq is not None:
        prim.append(np.abs(np.asarray(beq, np.float64)))
    if b_ineq is not None:
        b = np.asarray(b_ineq, np.float64)
        prim.append(np.abs(b[np.isfinite(b)]))
    prim = np.concatenate(prim) if prim else np.zeros(0)
    prim = prim[prim > 0]
    c = np.asarray(c, np.float64)
    dual = np.abs(c[c != 0])
    if prim.size and dual.size:
        return float(np.clip(np.median(prim) / np.median(dual), 1e-4, 1e4))
    return 1.0


@jax.jit
def _kkt_score(prob: LPProblem, x, y_eq, y_ineq):
    """KKT progress metric for restart decisions (PDLP-style): l2 primal
    infeasibility plus the relative duality gap of the box-dual bound."""
    d = prob.c
    primal_obj = jnp.dot(prob.c, x)
    dual_obj = jnp.asarray(0.0, x.dtype)
    pviol = jnp.asarray(0.0, x.dtype)
    if prob.a_eq is not None:
        d = d + prob.a_eq.rmatvec(y_eq)
        r = prob.a_eq.matvec(x) - prob.b_eq
        pviol = pviol + jnp.sum(r * r)
        dual_obj = dual_obj - jnp.dot(y_eq, prob.b_eq)
    if prob.a_ineq is not None:
        d = d + prob.a_ineq.rmatvec(y_ineq)
        r = jnp.maximum(prob.a_ineq.matvec(x) - prob.b_upper, 0.0)
        pviol = pviol + jnp.sum(r * r)
        dual_obj = dual_obj - jnp.dot(y_ineq, prob.b_upper)
    # box dual: min over l<=z<=u of d·z (finite for box-bounded variables)
    dual_obj = dual_obj + jnp.sum(
        jnp.where(d < 0, d * prob.ub, d * prob.lb)
    )
    gap = jnp.abs(primal_obj - dual_obj) / (
        1.0 + jnp.abs(primal_obj) + jnp.abs(dual_obj)
    )
    return jnp.sqrt(pviol + gap * gap)


def _choose_layout(mats, dtype):
    """Cost-compare the three candidate lowering layouts of the constraint
    systems ("align" / "rcm" / None) with the shared bytes-streamed model.

    Returns ``(choice, align_plan)`` — the anchor-alignment position plan
    is computed once here and reused by the caller when "align" wins
    (the alignment is O(nnz log nnz) host work; don't pay it twice).
    Systems small enough to lower dense keep their order: a permutation
    cannot help a launch-bound dense operator.
    """
    live = [m for m in mats if m is not None]
    if all(m.shape[0] * m.shape[1] <= DENSE_SMALL_MAX_ENTRIES for m in live):
        return None, None
    candidates = {}

    def total(parts, dt):
        # effective = min(whole-matrix layout, column-split composite):
        # permutation choices must not beat the split option by pricing
        # the unpermuted matrix with a layout the lowering won't use
        return sum(effective_stream_bytes(p, dt) for p in parts)

    candidates[None] = total(live, dtype)

    m_e = mats[0].shape[0] if mats[0] is not None else 0
    joint = live[0] if len(live) == 1 else scipy.sparse.vstack(live).tocsr()
    rows, cols = rcm_permutation(joint)
    perm_parts = []
    if mats[0] is not None:
        perm_parts.append(mats[0][rows[rows < m_e], :][:, cols])
    if mats[1] is not None:
        perm_parts.append(mats[1][rows[rows >= m_e] - m_e, :][:, cols])
    candidates["rcm"] = total(perm_parts, dtype)

    plan = None
    try:
        counts, m_new, n_new, plan = aligned_offset_count(
            mats, return_plan=True)
    except ValueError:
        counts = None
    if counts is not None and all(
        0 < c_ <= DIA_AUTO_MAX_OFFSETS for c_, m in zip(counts, mats)
        if m is not None
    ):
        # price the embedded systems with the same selector the lowering
        # runs (the alignment pads rows and columns)
        rows, col_pos, _m_new, n_new = plan
        candidates["align"] = total(
            [embed_matrix(m, r, col_pos, mn, n_new)
             for m, r, mn in zip(mats, rows, m_new) if m is not None],
            dtype)
    best = min(candidates, key=candidates.get)
    return best, (plan if best == "align" else None)


def build_cp_problem(c, a_eq, beq, a_one, b_ineq, lb, ub, dtype, alpha=1.0,
                     theta=1.0, lower=None):
    """Lower a one-sided LP (``a_eq x = beq``, ``a_one x <= b_ineq``,
    ``lb <= x <= ub``; absent systems are None) to ``(LPProblem, pre)``:
    each system through ``lower`` (the auto-selector by default) and the
    diagonal preconditioners (``ChambollePockPPD.py:122-179``):
    ``T_jj = 1 / sum_i |a_ij|^{2-alpha}``,
    ``Σ_ii = 1 / sum_j |a_ij|^{alpha}``."""
    n = np.asarray(c).size
    lower = lower or ell_from_scipy
    eq_m = lower(a_eq, dtype=dtype) if a_eq is not None else None
    in_m = lower(a_one, dtype=dtype) if a_one is not None else None
    prob = LPProblem(
        c=jnp.asarray(c, dtype),
        lb=jnp.asarray(lb, dtype),
        ub=jnp.asarray(ub, dtype),
        a_eq=eq_m,
        b_eq=jnp.asarray(beq, dtype) if a_eq is not None else None,
        a_ineq=in_m,
        b_lower=None,
        b_upper=jnp.asarray(b_ineq, dtype) if in_m is not None else None,
        n=n,
        m_eq=eq_m.nrows if eq_m is not None else 0,
        m_ineq=in_m.nrows if in_m is not None else 0,
    )
    col_sum = jnp.zeros(n, dtype)
    if eq_m is not None:
        col_sum = col_sum + eq_m.abs_power_colsum(2.0 - alpha)
    if in_m is not None:
        col_sum = col_sum + in_m.abs_power_colsum(2.0 - alpha)
    diag_t = 1.0 / jnp.where(col_sum == 0, 1.0, col_sum)
    pre = dict(diag_t=diag_t, theta=jnp.asarray(theta, dtype))
    if eq_m is not None:
        rs = eq_m.abs_power_rowsum(alpha)
        pre["sigma_eq"] = 1.0 / jnp.where(rs == 0, 1.0, rs)
    if in_m is not None:
        rs = in_m.abs_power_rowsum(alpha)
        pre["sigma_ineq"] = 1.0 / jnp.where(rs == 0, 1.0, rs)
    return prob, pre


def chambolle_pock_ppd(
    c,
    a_eq,
    beq,
    a_ineq,
    b_lower,
    b_upper,
    lb,
    ub,
    x0=None,
    alpha=1.0,
    theta=1.0,
    nb_max_iter=100,
    callback_func=None,
    max_time=None,
    save_problem=False,
    force_integer=False,
    nb_iter_plot=10,
    dtype=None,
    start_time=None,
    restart=None,
    omega=None,
    restart_period=None,
    stop_tol=None,
    permute="auto",
    y_eq0=None,
    y_ineq0=None,
    x30=None,
    light_metrics=False,
):
    """Solve the LP with preconditioned CP-PPD; returns ``(x, best_integer_solution)``.

    Signature-compatible with the reference solver
    (``pysparselp/ChambollePockPPD.py:36``).

    Acceleration beyond the reference (PDLP-style; Applegate et al. 2021):

    * ``omega`` — primal weight: primal steps scale by ``ω``, dual steps by
      ``1/ω`` (the τσ stability product is invariant).  ``"auto"`` estimates
      the primal/dual magnitude ratio from the problem data — on problems
      whose primal scale dwarfs the dual scale (netlib SC105: ‖x*‖≈700,
      ‖y*‖≈1) this alone cuts iterations-to-tolerance by >100×.
    * ``restart="average"`` — adaptive restart-to-average with KKT-score
      triggers and primal-weight re-estimation from observed movement at
      every restart (implies ``omega="auto"`` unless ω is given).

    Both off by default: the default trajectory is reference-faithful.

    Full-state resume (beyond the reference's primal-only ``x0``): pass
    ``y_eq0``/``y_ineq0``/``x30`` — e.g. from a ``CheckpointingCallback``
    checkpoint — to continue a run exactly where it stopped.  ``y_ineq0``
    is in the one-sided (folded) inequality space the solver reports.
    """
    if restart is not None and omega is None:
        omega = "auto"
    del save_problem  # repro dumps are handled by utils.save_arguments
    dtype = dtype or default_dtype()
    c = np.asarray(c, np.float64)
    n = c.size

    if a_eq is not None and a_eq.shape[0] == 0:
        a_eq, beq = None, None
    a_one, b_ineq = _fold_one_sided(a_ineq, b_lower, b_upper)
    if a_one is not None and a_one.shape[0] == 0:
        a_one, b_ineq = None, None

    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)

    # Layout presolve: re-ordering rows/columns ONCE at lowering changes
    # which operator backend wins, at zero per-iteration cost.  Two
    # candidate layouts are costed against the unpermuted matrix with the
    # shared bytes-streamed model (problem.estimate_stream_bytes):
    #
    # * "rcm"   — reverse Cuthill-McKee bandwidth reduction: clusters the
    #   nonzeros into dense tiles for the block-ELL backend;
    # * "align" — anchor-aligned embedding (problem.anchor_align): collapses
    #   template-structured LPs (image grids: Potts) onto a handful of exact
    #   diagonals for the shift DIA operator (Potts-50: 17 diagonals vs 107
    #   raw / 2412 after RCM).
    #
    # The primal-weight estimate uses the ORIGINAL rhs (the aligned
    # embedding pads b with a large sentinel that must not enter medians).
    if omega == "auto":
        omega = estimate_omega(c, beq if a_eq is not None else None,
                               b_ineq if a_one is not None else None)
    if permute is True:
        permute = "rcm"
    layout = None
    inv_cols = None          # orig col -> solved position (gather for x)
    pos_eq = pos_in = None   # orig row -> solved position (per system)
    if permute and (a_eq is not None or a_one is not None):
        mats = [a_eq, a_one]
        choice = permute if permute in ("rcm", "align") else None
        align_plan = None
        if choice is None:
            choice, align_plan = _choose_layout(mats, dtype)
        sys = dict(a_eq=a_eq, beq=beq, a_ineq=a_one, b_ineq=b_ineq,
                   c=c, lb=lb, ub=ub, x0=x0, x30=x30,
                   y_eq0=y_eq0, y_ineq0=y_ineq0)
        col_pos = None
        layout = choice
        if choice == "align":
            plan = (align_plan if align_plan is not None
                    else anchor_align(mats))
            sys, pos_eq, pos_in, col_pos = apply_align_embedding(plan, sys)
        elif choice == "rcm":
            sys, pos_eq, pos_in, col_pos = apply_rcm_permutation(sys)
        if col_pos is not None:
            a_eq, beq = sys["a_eq"], sys["beq"]
            a_one, b_ineq = sys["a_ineq"], sys["b_ineq"]
            c, lb, ub = sys["c"], sys["lb"], sys["ub"]
            x0, x30 = sys["x0"], sys["x30"]
            y_eq0, y_ineq0 = sys["y_eq0"], sys["y_ineq0"]
            # x_orig[j] = x_solved[col_pos[j]]
            inv_cols = col_pos
            n = c.size
            if callback_func is not None:
                user_cb = callback_func

                if getattr(user_cb, "wants_solution", True):
                    def callback_func(niter, xp, *rest, **kw):
                        user_cb(niter, np.asarray(xp)[inv_cols], *rest, **kw)
                else:
                    # light-metrics recorder: never touches the solution —
                    # skip the per-checkpoint device fetch + unpermute
                    def callback_func(niter, xp, *rest, **kw):
                        user_cb(niter, xp, *rest, **kw)

                callback_func.wants_state = getattr(user_cb, "wants_state",
                                                    False)
                callback_func.wants_solution = getattr(
                    user_cb, "wants_solution", True)

    if a_eq is None and a_one is None:
        # unconstrained: minimize cᵀx over the box (``ChambollePockPPD.py:147-151``)
        x = np.zeros_like(lb)
        x[c > 0] = lb[c > 0]
        x[c < 0] = ub[c < 0]
        return x, None

    prob, pre = build_cp_problem(c, a_eq, beq, a_one, b_ineq, lb, ub, dtype,
                                 alpha=alpha, theta=theta)
    eq_m, in_m = prob.a_eq, prob.a_ineq
    # (omega="auto" was resolved before the layout presolve)
    omega = float(omega) if omega is not None else 1.0
    pre_eff = _scale_pre(pre, omega) if omega != 1.0 else pre

    x = jnp.asarray(x0 if x0 is not None else np.zeros(n), dtype)
    ye0 = np.zeros(prob.m_eq) if y_eq0 is None else np.asarray(y_eq0)
    yi0 = np.zeros(prob.m_ineq) if y_ineq0 is None else np.asarray(y_ineq0)
    state = (
        x,
        jnp.asarray(x30, dtype) if x30 is not None else x,
        jnp.asarray(ye0, dtype) if eq_m is not None else jnp.zeros(0, dtype),
        jnp.asarray(yi0, dtype) if in_m is not None else jnp.zeros(0, dtype),
    )

    def _callback_state():
        """Full solver state in original (un-permuted) coordinates."""
        sx, sx3, sye, syi = (to_np(v) for v in state)
        if inv_cols is not None:
            sx, sx3 = sx[inv_cols], sx3[inv_cols]
            if pos_eq is not None and sye.size:
                sye = sye[pos_eq]
            if pos_in is not None and syi.size:
                syi = syi[pos_in]
        return {"x": sx, "x3": sx3, "y_eq": sye, "y_ineq": syi}

    loop = HostLoop(start_time=start_time, max_time=max_time)
    best_integer_solution = None
    best_integer_energy = np.inf
    niter = 0
    # device-resident PDLP restart controller state (restart="average"):
    # seeded with the KKT score of the initial point; checks run on device
    # every restart_period iterations with no host synchronization
    rstate = None
    if restart == "average":
        if restart_period is not None and restart_period > nb_iter_plot:
            import warnings

            warnings.warn(
                f"restart_period={restart_period} exceeds the metrics chunk "
                f"size nb_iter_plot={nb_iter_plot}; restart checks run at "
                "chunk boundaries, so the effective period is clamped to "
                "nb_iter_plot. Raise nb_iter_plot to check less often.",
                stacklevel=2,
            )
        period = int(min(restart_period or nb_iter_plot, nb_iter_plot))
        rstate = {
            "state": state,
            "omega": jnp.asarray(omega, dtype),
            "mu_restart": _kkt_score(prob, state[0], state[2],
                                     state[3]).astype(dtype),
            "mu_last": jnp.asarray(np.inf, dtype),
            "zx": state[0],
            "zeq": state[2],
            "zineq": state[3],
        }

    # small dense LPs (the netlib class) on a GPU: whole chunks in one
    # Pallas kernel — the XLA iteration there is a dozen tiny launches
    use_fused = ("dense" if cp_dense_fused_eligible(prob)
                 and jax.default_backend() == "gpu" else None)
    global last_plan
    last_plan = {
        "layout": layout,
        "eq": type(eq_m).__name__ if eq_m is not None else None,
        "ineq": type(in_m).__name__ if in_m is not None else None,
        "fused": use_fused,
    }
    for nsteps in chunk_schedule(nb_max_iter, nb_iter_plot):
        if restart == "average":
            rstate, metrics = _cp_chunk_restart_device(
                prob, pre, rstate, nsteps, period,
                use_fused=use_fused, theta_f=float(theta),
            )
            state = rstate["state"]
        elif use_fused:
            state = cp_dense_fused_chunk(prob, pre_eff, state, nsteps, theta)
            _, metrics = _cp_chunk(prob, pre_eff, state, 0)
        else:
            state, metrics = _cp_chunk(prob, pre_eff, state, nsteps)
        niter += nsteps
        if force_integer and bool(metrics["rounded_feasible"]):
            er = float(metrics["energy_rounded"])
            if er < best_integer_energy:
                best_integer_energy = er
                best_integer_solution = np.round(to_np(state[0]))
        emit_callback(
            callback_func,
            niter,
            state[0],
            metrics["energy1"],
            metrics["energy2"],
            lambda: loop.elapsed,
            metrics["max_violated_equality"],
            metrics["max_violated_inequality"],
            state=(
                _callback_state()
                if getattr(callback_func, "wants_state", False)
                else None
            ),
            light=light_metrics,
        )
        if loop.timed_out:
            break
        if stop_tol is not None:
            # tolerance termination (beyond the reference, which only has
            # iteration/time budgets): feasibility + relative gap of the
            # chunk metrics below stop_tol
            e1, e2 = float(metrics["energy1"]), float(metrics["energy2"])
            gap = abs(e1 - e2) / (1.0 + abs(e1) + abs(e2))
            feas = max(float(metrics["max_violated_equality"]),
                       float(metrics["max_violated_inequality"]))
            if feas < stop_tol and gap < stop_tol:
                break

    x_final = to_np(state[0])
    if inv_cols is not None:
        x_final = x_final[inv_cols]
        if best_integer_solution is not None:
            best_integer_solution = best_integer_solution[inv_cols]
    return x_final, best_integer_solution
