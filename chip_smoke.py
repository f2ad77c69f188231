"""On-device smoke test of the solver's main paths on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py                # every one-card phase
    python chip_smoke.py --four-cards   # only the four-card mesh phase

It drives the public entry points (``SparseLP.solve``, ``solve_cp_batch``,
``lp.solve(..., mesh=...)``) at the sizes users run, compares each result
with a certified optimum or with the plain float64 scipy CP-PPD loop below,
and prints one line per phase with its numbers, tolerance and precision.
Any phase that does not hold raises, so the script exits non-zero and
prints no result line; so does a run where JAX finds no GPU.  The last line
is the JSON result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpu():
    """The JAX module, or exit 2 when its first device is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)
    return jax


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def fold_one_sided(a, b_lower, b_upper):
    """``bl <= A x <= bu`` as ``A' x <= b'``: finite upper rows first, then
    the negated finite lower rows (the solver's convention)."""
    import scipy.sparse

    a = scipy.sparse.csr_matrix(a)
    if b_lower is None:
        return a, np.asarray(b_upper, np.float64)
    up = np.nonzero(np.isfinite(b_upper))[0]
    lo = np.nonzero(np.isfinite(b_lower))[0]
    a2 = scipy.sparse.vstack([a[up], -a[lo]]).tocsr()
    return a2, np.concatenate([b_upper[up], -b_lower[lo]])


def plain_cp(c, a_eq, b_eq, a_in, b_in, lb, ub, iters):
    """Plain CP-PPD (Pock & Chambolle 2011, diagonal preconditioning with
    alpha = 1, theta = 1) on scipy CSR matrices in float64; either system
    may be None.  Returns ``(x, y_eq, y_in)``."""
    systems = [(a, b) for a, b in ((a_eq, b_eq), (a_in, b_in))
               if a is not None]
    col = sum(np.asarray(abs(a).sum(axis=0)).ravel() for a, _ in systems)
    tau = 1.0 / np.where(col == 0, 1.0, col)

    def sigma(a):
        row = np.asarray(abs(a).sum(axis=1)).ravel()
        return 1.0 / np.where(row == 0, 1.0, row)

    x = np.zeros(c.size)
    ye = np.zeros(a_eq.shape[0]) if a_eq is not None else None
    yi = np.zeros(a_in.shape[0]) if a_in is not None else None
    at_eq = a_eq.T.tocsr() if a_eq is not None else None
    at_in = a_in.T.tocsr() if a_in is not None else None
    s_eq = sigma(a_eq) if a_eq is not None else None
    s_in = sigma(a_in) if a_in is not None else None
    for _ in range(iters):
        d = c.copy()
        if a_eq is not None:
            d += at_eq @ ye
        if a_in is not None:
            d += at_in @ yi
        x_new = np.clip(x - tau * d, lb, ub)
        x3 = 2.0 * x_new - x
        x = x_new
        if a_eq is not None:
            ye = ye + s_eq * (a_eq @ x3 - b_eq)
        if a_in is not None:
            yi = np.maximum(yi + s_in * (a_in @ x3 - b_in), 0.0)
    return x, ye, yi


class StateRecorder:
    """``lp.solve`` callback keeping the last full solver state."""

    wants_state = True

    def __init__(self):
        self.state = None

    def __call__(self, *args, state=None):
        self.state = state


def solve_with_state(lp, iters, **kw):
    """``lp.solve`` CP-PPD in float32 for ``iters`` iterations; returns
    ``(x, state)`` with the duals of the one-sided system."""
    rec = StateRecorder()
    x, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=iters,
                    nb_iter_plot=iters, dtype=np.float32,
                    callback_func=rec, **kw)
    return np.asarray(x, np.float64), rec.state


def rel_err(got, ref):
    """max |got - ref| relative to max(1, max |ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(got - ref)) / max(1.0, np.max(np.abs(ref))))


def compare_with_plain_cp(lp, iters, tol):
    """Solve ``lp`` with the library (float32) and the plain reference
    (float64) for ``iters`` iterations; returns the errors and the plan."""
    from pysparselp_tpu.solvers import chambolle_pock as cpm

    check(np.all(lp.lower_bounds < lp.upper_bounds),
          "the comparison assumes no fixed variables")
    t0 = time.perf_counter()
    x, state = solve_with_state(lp, iters)
    t_solve = time.perf_counter() - t0
    plan = dict(cpm.last_plan)
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities is not None else None
    a_in, b_in = None, None
    if lp.a_inequalities is not None:
        a_in, b_in = fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower,
                                    lp.b_upper)
    t0 = time.perf_counter()
    xr, yer, yir = plain_cp(
        np.asarray(lp.costsvector, np.float64), a_eq,
        None if a_eq is None else np.asarray(lp.b_equalities, np.float64),
        a_in, b_in, lp.lower_bounds, lp.upper_bounds, iters)
    t_ref = time.perf_counter() - t0
    errs = {"x": rel_err(x, xr)}
    if yer is not None:
        errs["y_eq"] = rel_err(state["y_eq"], yer)
    if yir is not None:
        errs["y_ineq"] = rel_err(state["y_ineq"], yir)
    check(max(errs.values()) <= tol, f"solver vs plain CP: {errs} > {tol}")
    return errs, plan, t_solve, t_ref


@contextlib.contextmanager
def dense_kernel(enabled):
    """Let the solver pick the dense Triton kernel, or keep it on the XLA
    iteration (for the timing comparison)."""
    from pysparselp_tpu.solvers import chambolle_pock as cpm

    orig = cpm.cp_dense_fused_eligible
    if not enabled:
        cpm.cp_dense_fused_eligible = lambda prob: False
    try:
        yield
    finally:
        cpm.cp_dense_fused_eligible = orig


def phase_sc105(tol=1e-3):
    """SC105 to mean-abs distance < tol from the perPlex optimum, with the
    dense Triton kernel and with the XLA iteration; then Mehrotra in f64."""
    import bench
    from pysparselp_tpu.solvers import chambolle_pock as cpm

    lp, gt = bench._sc105_lp()
    kw = dict(method="chambolle_pock_ppd", nb_iter=72_000,
              nb_iter_plot=4_000, restart="average", restart_period=4_000,
              dtype=np.float32, ground_truth=gt,
              ground_truth_indices=np.arange(gt.size))
    res = {}
    for name, fused in (("triton", True), ("xla", False)):
        with dense_kernel(fused):
            lp.solve(**kw)          # compile
            lp.solve(**kw)
        plan = dict(cpm.last_plan)
        dists = np.asarray(lp.distance_to_ground_truth)
        below = np.nonzero(dists < tol)[0]
        check(below.size, f"SC105 {name}: best distance {dists.min()}")
        res[name] = (float(lp.opttime_curve[below[0]]),
                     int(lp.itrn_curve[below[0]]), plan)
        check((plan["fused"] == "dense") == fused,
              f"SC105 {name}: kernel choice {plan}")
    print(f"phase sc105_cp: f32, tol mean|x-x*|<{tol}; "
          f"triton {res['triton'][0]:.4f} s at {res['triton'][1]} it, "
          f"xla {res['xla'][0]:.4f} s at {res['xla'][1]} it; "
          f"backends eq={res['triton'][2]['eq']} "
          f"ineq={res['triton'][2]['ineq']} "
          f"layout={res['triton'][2]['layout']}", flush=True)

    t0 = time.perf_counter()
    x, _ = lp.solve(method="mehrotra", nb_iter=60, dtype=np.float64)
    dist = float(np.mean(np.abs(np.asarray(x) - gt)))
    check(dist < 1e-6, f"SC105 mehrotra distance {dist}")
    print(f"phase sc105_mehrotra: f64, mean|x-x*|={dist:.3e} (tol 1e-6), "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def phase_dense_kernel(iters=500, tol=1e-4):
    """The dense Triton kernel against the XLA chunk (both f32) on the
    vendored netlib LPs.  Tolerance: the kernel sums in another order than
    XLA's HIGHEST-precision dots, so iterates differ by f32 rounding that
    the iteration carries along, not by a different algorithm."""
    import jax
    import jax.numpy as jnp

    import bench
    from pysparselp_tpu.ops.cp_dense_triton import (
        cp_dense_fused_call, cp_dense_fused_eligible)
    from pysparselp_tpu.problem import ell_from_scipy
    from pysparselp_tpu.solvers.chambolle_pock import (
        _fold_one_sided, build_cp_problem, cp_chunk_impl)

    chunk = jax.jit(cp_chunk_impl, static_argnames="nsteps")
    worst = {}
    for name in ("SC105", "AFIRO", "KB2", "SC50A", "SC50B"):
        lp, _gt = bench._netlib_lp(name)
        a_eq = lp.a_equalities.tocsr() if lp.a_equalities is not None \
            else None
        a_in, b_in = _fold_one_sided(lp.a_inequalities.tocsr(), lp.b_lower,
                                     lp.b_upper)
        prob, pre = build_cp_problem(
            lp.costsvector, a_eq, lp.b_equalities, a_in, b_in,
            lp.lower_bounds, lp.upper_bounds, jnp.float32,
            lower=lambda a, dtype: ell_from_scipy(a, dtype, prefer="dense"))
        check(cp_dense_fused_eligible(prob), f"{name}: kernel ineligible")
        x0 = jnp.zeros(prob.n, jnp.float32)
        ye0 = jnp.zeros(prob.m_eq, jnp.float32)
        yi0 = jnp.zeros(prob.m_ineq, jnp.float32)
        ref, _ = chunk(prob, pre, (x0, x0, ye0, yi0), nsteps=iters)
        got = cp_dense_fused_call(prob, pre, x0, ye0, yi0, iters, 1.0)
        worst[name] = max(rel_err(g, r) for g, r in zip(got, ref))
        check(worst[name] <= tol, f"{name}: kernel vs XLA {worst[name]}")
    print(f"phase dense_kernel: f32, {iters} it, max rel err vs XLA chunk "
          + ", ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f" (tol {tol})", flush=True)

    # f32 products must not degrade to TF32 (~3 decimal digits)
    from pysparselp_tpu.problem import DenseMatrix

    rng = np.random.RandomState(0)
    a = rng.randn(2048, 2048).astype(np.float32)
    v = rng.randn(2048).astype(np.float32)
    op = DenseMatrix(a=jnp.asarray(a), nrows=2048, ncols=2048)
    ref = a.astype(np.float64) @ v.astype(np.float64)
    err = float(np.max(np.abs(np.asarray(op.matvec(jnp.asarray(v))) - ref))
                / np.max(np.abs(ref)))
    check(err < 1e-5, f"dense f32 matvec error {err}: TF32?")
    print(f"phase f32_precision: dense matvec 2048^2 rel err {err:.2e} "
          f"(tol 1e-5; TF32 would give ~1e-3)", flush=True)


def phase_potts_reference(size=1000, iters=200, tol=1e-3):
    """Potts-``size`` (12M nnz at 1000) through ``lp.solve`` in f32 against
    the plain float64 CP loop; tolerance covers f32 rounding carried over
    ``iters`` iterations."""
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, _gt, _idx, _ = build_linear_program(size, 0.5, 500)
    nnz = lp.a_inequalities.tocsr().nnz
    errs, plan, t_solve, t_ref = compare_with_plain_cp(lp, iters, tol)
    print(f"phase potts{size}_reference: f32 vs f64 plain CP, {nnz} nnz, "
          f"{iters} it, rel err {errs} (tol {tol}); layout={plan['layout']} "
          f"ineq={plan['ineq']}; solve {t_solve:.2f} s, "
          f"reference {t_ref:.2f} s", flush=True)
    return lp


def phase_potts_graphcut(size=50):
    """Potts-``size`` with restart-to-average: the rounded labels equal the
    exact graph-cut (scipy max-flow) segmentation."""
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, gt, idx, _ = build_linear_program(size, 0.5, 500)
    t0 = time.perf_counter()
    x, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=36_000,
                    nb_iter_plot=4_000, restart="average",
                    restart_period=4_000, dtype=np.float32)
    labels = np.round(np.asarray(x)[idx])
    wrong = int(np.sum(labels != gt))
    dist = float(np.mean(np.abs(np.asarray(x)[idx] - gt)))
    check(wrong == 0, f"potts{size}: {wrong} labels differ from graph cut")
    print(f"phase potts{size}_graphcut: f32, rounded labels == graph cut "
          f"({gt.size} pixels, mean|x-gt|={dist:.2e}), "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_transport(iters=200, tol=1e-3, **size):
    """Transport LP (100k x 1M arcs, 2M nnz by default) against the plain
    float64 CP loop."""
    import bench

    lp = bench._transport_lp(**size)
    errs, plan, t_solve, t_ref = compare_with_plain_cp(lp, iters, tol)
    print(f"phase transport: f32 vs f64 plain CP, "
          f"{lp.a_equalities.nnz} nnz, {iters} it, rel err {errs} "
          f"(tol {tol}); layout={plan['layout']} eq={plan['eq']}; "
          f"solve {t_solve:.2f} s, reference {t_ref:.2f} s", flush=True)


def phase_batch(bsz=16, iters=200, tol=1e-4, **size):
    """``solve_cp_batch`` over ``bsz`` cost variants of the 150k-row banded
    LP against one ``lp.solve`` per variant at the same iteration count.
    Tolerance: the batch and the single solves reduce in different orders
    (and the single solve may permute the layout), so they agree to f32
    rounding, not bit for bit."""
    import bench
    from pysparselp_tpu import solve_cp_batch

    lp = bench._banded_lp(**size)
    rng = np.random.RandomState(0)
    costs = lp.costsvector[None, :] + 0.1 * rng.randn(bsz, lp.nb_variables)
    t0 = time.perf_counter()
    xb, info = solve_cp_batch(lp, costs=costs, nb_iter=iters,
                              dtype=np.float32)
    t_batch = time.perf_counter() - t0
    errs = []
    for i in range(bsz):
        lp_i = copy.deepcopy(lp)
        lp_i.costsvector = costs[i].copy()
        x_i, _ = lp_i.solve(method="chambolle_pock_ppd", nb_iter=iters,
                            nb_iter_plot=iters, dtype=np.float32)
        errs.append(rel_err(xb[i], x_i))
    check(max(errs) <= tol, f"batch vs single: {max(errs)} > {tol}")
    print(f"phase batch: f32, B={bsz}, {lp.nb_variables} vars, {iters} it, "
          f"backend={info['backend']['ineq']}, max rel err vs single "
          f"solves {max(errs):.2e} (tol {tol}); batch {t_batch:.2f} s",
          flush=True)


def phase_four_cards(size=1000, iters=200, tol=1e-3, ndev=4):
    """Potts-``size`` row-sharded over ``ndev`` devices through
    ``lp.solve(..., mesh=...)`` against the one-device solve at the same
    iteration count.  Tolerance: the mesh path reduces ``Aᵀy`` with a psum
    over shards, so the two differ by f32 rounding."""
    from pysparselp_tpu.examples.potts import build_linear_program
    from pysparselp_tpu.parallel import sharded_cp
    from pysparselp_tpu.parallel.mesh import default_mesh

    lp, _gt, _idx, _ = build_linear_program(size, 0.5, 500)
    kw = dict(method="chambolle_pock_ppd", nb_iter=iters, nb_iter_plot=iters,
              dtype=np.float32)
    t0 = time.perf_counter()
    x1, _ = lp.solve(**kw)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    xm, _ = lp.solve(mesh=default_mesh(ndev), **kw)
    tm = time.perf_counter() - t0
    plan = dict(sharded_cp.last_plan)
    devs = sorted(set(plan["shard_devices"]))
    check(len(devs) == ndev, f"dual shards on devices {devs}")
    check(plan["operator"] == "dia", f"mesh operator {plan}")
    err = rel_err(xm, x1)
    check(err <= tol, f"mesh vs one device: {err} > {tol}")
    print(f"phase four_cards: f32, potts{size}, {iters} it, "
          f"layout={plan['layout']} operator={plan['operator']}, shards on "
          f"devices {devs}, max rel err vs one device {err:.2e} (tol {tol}); "
          f"one device {t1:.2f} s, mesh {tm:.2f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    jax = require_gpu()
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from pysparselp_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache(ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = jax.devices()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"jax device: {dev.device_kind} x{len(jax.devices())}", flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        check(len(jax.devices()) >= 4, "--four-cards needs four GPUs")
        phase_four_cards()
    else:
        phase_sc105()
        phase_dense_kernel()
        phase_potts_reference()
        phase_potts_graphcut()
        phase_transport()
        phase_batch()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
