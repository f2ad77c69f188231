"""Observability helpers: solution statistics, call capture, profiling.

Device-side equivalents of the reference's instrumentation layer
(``pysparselp/tools.py:173-269`` — ``SolutionStat``, ``save_arguments`` —
and the ad-hoc per-loop prints): a callback-protocol statistics tracker, a
pickle-based repro capture, and a ``jax.profiler`` trace context for real
device profiles instead of host tic/tocs.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import pickle
import time

import numpy as np


class SolutionStat:
    """Tracks solver progress through the standard callback protocol.

    Equivalent of the reference's curve tracker (``tools.py:173-242``): per
    callback records iteration, wall-clock, primal/dual energies, violations,
    the true cost/violation recomputed from the LP, and — when the problem is
    0/1-integer — whether the rounded iterate is feasible and its cost.

    Use as ``lp.solve(..., callback_func=stat)`` (instances are callable) or
    compose with another callback via ``stat.wrap(cb)``.
    """

    def __init__(self, lp=None, tol=1e-6):
        self.lp = lp
        self.tol = tol
        self.iterations = []
        self.times = []
        self.energies1 = []
        self.energies2 = []
        self.max_violations_eq = []
        self.max_violations_ineq = []
        self.costs = []
        self.true_violations = []
        self.rounded_feasible = []
        self.rounded_costs = []
        self.best_rounded_cost = np.inf
        self.best_rounded_solution = None

    def __call__(self, niter, solution, energy1, energy2, duration,
                 max_violated_eq, max_violated_ineq, **_):
        self.iterations.append(int(niter))
        self.times.append(float(duration))
        self.energies1.append(float(energy1))
        self.energies2.append(float(energy2))
        self.max_violations_eq.append(float(max_violated_eq))
        self.max_violations_ineq.append(float(max_violated_ineq))
        if self.lp is not None:
            solution = np.asarray(solution)
            self.costs.append(float(self.lp.cost(solution)))
            viol = float(self.lp.max_constraint_violation(solution))
            self.true_violations.append(viol)
            r = np.round(solution)
            rviol = float(self.lp.max_constraint_violation(r))
            feas = rviol < self.tol
            self.rounded_feasible.append(feas)
            rcost = float(self.lp.cost(r))
            self.rounded_costs.append(rcost)
            if feas and rcost < self.best_rounded_cost:
                self.best_rounded_cost = rcost
                self.best_rounded_solution = r

    def wrap(self, callback):
        """Chain: record stats, then forward to ``callback``."""

        def chained(*args, **kw):
            self(*args, **kw)
            if callback is not None:
                callback(*args, **kw)

        return chained

    def summary(self) -> dict:
        return {
            "niter": self.iterations[-1] if self.iterations else 0,
            "elapsed": self.times[-1] if self.times else 0.0,
            "final_cost": self.costs[-1] if self.costs else None,
            "final_violation": (
                self.true_violations[-1] if self.true_violations else None
            ),
            "best_rounded_cost": (
                None if self.best_rounded_cost == np.inf
                else self.best_rounded_cost
            ),
        }


def save_arguments(filename, level: int = 1):
    """Pickle the calling function's arguments for offline repro.

    Equivalent of ``tools.py:245-269``: captures the caller's bound locals
    (its arguments at entry) into ``filename`` so a failing solver call can
    be replayed standalone.
    """
    frame = inspect.stack()[level].frame
    args, _, _, values = inspect.getargvalues(frame)
    payload = {}
    for name in args:
        v = values[name]
        try:
            pickle.dumps(v)
        except Exception:
            continue
        payload[name] = v
    with open(filename, "wb") as f:
        pickle.dump(payload, f)
    return payload


def load_arguments(filename) -> dict:
    with open(filename, "rb") as f:
        return pickle.load(f)


@contextlib.contextmanager
def profile_trace(log_dir=None, enabled=True):
    """Capture a ``jax.profiler`` device trace around a solver run.

    The device replacement for the reference's host-side ``Chrono`` tic/tocs
    (``tools.py:34-44``, ``ADMM.py:110-113``): wall-clock around a dispatch
    measures nothing on an async device — a profiler trace shows the real
    kernel timeline.  View with TensorBoard or Perfetto.
    """
    if not enabled:
        yield None
        return
    import jax

    log_dir = log_dir or os.path.join(
        os.getcwd(), f"jax_trace_{int(time.time())}"
    )
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
