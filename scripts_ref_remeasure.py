"""Measure the reference CP-PPD iteration rate on a bench workload, on
THIS host's CPU, through the reference's own API.

Methodology (identical to the recorded unstructured / k-medians
baselines): py3.12 shims (``time.clock``, ``np.float``), the per-
checkpoint metrics block disabled via a huge ``nb_iter_plot``, one warm
run, then the iteration rate is the WALL-CLOCK DELTA between an 800- and
a 200-iteration budget (so setup/preconditioning time cancels), twice;
the HIGHER run is recorded so the published speedup is conservative.

Usage (host CPU only):
    python scripts_ref_remeasure.py transport
"""
import sys
import time

import numpy as np

# py3.12+ shims for the 2016-era reference
time.clock = time.perf_counter
np.float = float  # noqa: NPY001

sys.path.insert(0, "/root/reference")
sys.path.insert(0, "/root/repo")

# the workload builders import jax transitively — pin it to the CPU so
# the reference and the builders share the host
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pysparselp.ChambollePockPPD import chambolle_pock_ppd  # noqa: E402

import bench  # noqa: E402


def _transport_args():
    lp = bench._transport_lp()
    return dict(
        c=lp.costsvector, a_eq=lp.a_equalities.tocsr(),
        beq=lp.b_equalities, a_ineq=lp.a_inequalities.tocsr(),
        b_lower=lp.b_lower, b_upper=lp.b_upper,
        lb=lp.lower_bounds, ub=lp.upper_bounds)


WORKLOADS = {"transport": _transport_args}


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "transport"
    args = WORKLOADS[name]()

    def run(nb):
        t0 = time.perf_counter()
        chambolle_pock_ppd(nb_max_iter=nb, nb_iter_plot=10**9, **args)
        return time.perf_counter() - t0

    run(50)  # warm caches
    rates = []
    for _ in range(2):
        t200 = run(200)
        t800 = run(800)
        rates.append(600.0 / (t800 - t200))
    print({"workload": name,
           "runs_iters_per_sec": [round(r, 2) for r in sorted(rates)],
           "record": round(max(rates), 1)})


if __name__ == "__main__":
    main()
