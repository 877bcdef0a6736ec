"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and the TF32 guard on the headline program.

The phases' numerical checks are the same code the card runs; only the sizes
differ.
"""
import json
import re

import numpy as np
import pytest

import jax

import chip_smoke


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert out == ""


def test_phase_linear_tiny():
    out = chip_smoke.phase_linear(n=64, cond=1e3, cands=4)
    assert out["host_c128_rel"] <= 1e-8
    assert out["evolve_memory"]["argument_bytes"] > 0


def test_phase_linear_large_tiny():
    out = chip_smoke.phase_linear_large(n=96, cond=1e3, cands=4)
    assert out["device_c128_rel"] <= 1e-8
    assert out["host_refactor"] is False


def test_phase_residual_tiny():
    out = chip_smoke.phase_residual(n=64, reps=2)
    assert out["max_abs_diff_vs_numpy"] <= out["bound"]
    assert out["native_s"] > 0 and out["ladder_s"] > 0


def test_phase_eig_tiny():
    out = chip_smoke.phase_eig(n=32, targets=4, hess_n=32, hess_k=4)
    for kind in ("general", "hermitian"):
        assert out[kind]["num_distinct"] >= 4
        assert out[kind]["max_numpy_resid"] <= 1e-8
    assert out["hess_sweep"]["cand0_rel_resid"] <= 1e-3


def test_phase_svd_tiny():
    out = chip_smoke.phase_svd(m=24, n=16, rank=3)
    assert out["max_numpy_resid"] <= 1e-8


def test_phase_age_tiny():
    out = chip_smoke.phase_age(cycles=1, cands=4)
    assert np.isfinite(out["best_fitness"])


def test_phase_mesh_tiny():
    """The --four path on four of the suite's virtual CPU devices."""
    out = chip_smoke.phase_mesh(n=64, cond=1e3, n_devices=4)
    assert out["one_card"]["host_c128_rel"] <= 1e-8
    assert out["mesh"]["host_c128_rel"] <= 1e-8
    assert len(out["devices"]) == 4


def test_phase_results_are_json():
    out = chip_smoke.phase_age(cycles=1, cands=2, seed=1)
    json.loads(json.dumps(out, default=float))


def test_headline_program_dots_are_highest_precision():
    """Every dot_general on f32/c64 operands in the headline program (the
    evolve loop plus refine_split_c64exact, as bench.py builds it) carries
    HIGHEST precision: on the GPU a float32 or complex64 product at default
    precision may run in TF32 (~3 decimal digits)."""
    import bench

    fn, args, _ = bench.build_solve(64, cands=4)
    text = fn.lower(*args).as_text()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    low = [ln for ln in dots if re.search(r"tensor<[^>]*x(f32|complex<f32>)>",
                                          ln)]
    assert low, "expected f32/c64 products in the headline program"
    unguarded = [ln.strip() for ln in low if "HIGHEST" not in ln]
    assert not unguarded, unguarded[:3]
