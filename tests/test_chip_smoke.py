"""The on-device smoke script's CPU-checkable parts: its plain float64
CP-PPD reference, its device guard, and the compile-cache location."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _solver_vs_plain(lp, iters):
    rec = chip_smoke.StateRecorder()
    x, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=iters,
                    nb_iter_plot=iters, dtype=np.float64, callback_func=rec)
    a_eq = lp.a_equalities.tocsr() if lp.a_equalities is not None else None
    a_in, b_in = chip_smoke.fold_one_sided(lp.a_inequalities.tocsr(),
                                           lp.b_lower, lp.b_upper)
    ref = chip_smoke.plain_cp(
        np.asarray(lp.costsvector, np.float64), a_eq,
        None if a_eq is None else np.asarray(lp.b_equalities, np.float64),
        a_in, b_in, lp.lower_bounds, lp.upper_bounds, iters)
    return (x, rec.state), ref


def test_plain_cp_matches_solver_on_potts():
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, _gt, _idx, _ = build_linear_program(14, 0.5, 500)
    (x, state), (xr, _ye, yir) = _solver_vs_plain(lp, 150)
    np.testing.assert_allclose(x, xr, atol=1e-9)
    np.testing.assert_allclose(state["y_ineq"], yir, atol=1e-9)


def test_plain_cp_matches_solver_with_equalities():
    lp = bench._transport_lp(n_sources=40, n_sinks=30, n_arcs=400)
    (x, state), (xr, yer, yir) = _solver_vs_plain(lp, 120)
    np.testing.assert_allclose(x, xr, atol=1e-9)
    np.testing.assert_allclose(state["y_eq"], yer, atol=1e-9)
    np.testing.assert_allclose(state["y_ineq"], yir, atol=1e-9)


def test_compare_with_plain_cp_reports_small_errors():
    from pysparselp_tpu.examples.potts import build_linear_program

    lp, _gt, _idx, _ = build_linear_program(10, 0.5, 500)
    errs, plan, _ts, _tr = chip_smoke.compare_with_plain_cp(lp, 60, 1e-3)
    assert max(errs.values()) < 1e-4
    assert plan["ineq"] is not None


def test_device_guard_exits_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert res.returncode == 2, res.stderr
    assert "needs a GPU" in res.stderr
    for line in res.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    import jax

    from pysparselp_tpu.utils.compile_cache import configure_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert configure_compile_cache(ROOT) == str(tmp_path / "env")
    assert calls == []


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    import jax

    from pysparselp_tpu.utils.compile_cache import configure_compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = configure_compile_cache(ROOT)
    assert path == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    # the same checkout always maps to the same directory
    assert configure_compile_cache(str(ROOT) + "/") == path
