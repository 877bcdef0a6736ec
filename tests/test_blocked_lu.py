"""Blocked partially-pivoted LU (ops/blocked_lu.py) vs dense oracles.

Reference parity: the LU is the device equivalent of the reference's dense
direct path (LAPACK getrf/getrs behind ``sla.solve``,
Adaptive_Matrix_Solver_0.1.py:59).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from maus_tpu.ops.blocked_lu import BlockedLU, factor_lu, solve_lu


def _rand(n, dtype, seed=0, cond=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal((n, n))
    if cond is not None:
        u, _, vt = np.linalg.svd(A)
        s = np.logspace(0, -np.log10(cond), n)
        A = (u * s) @ vt
    return jnp.asarray(A, dtype)


def _reconstruct(fac: BlockedLU, n):
    lu = np.asarray(fac.lu)
    L = np.tril(lu, -1) + np.eye(n, dtype=lu.dtype)
    U = np.triu(lu)
    return L @ U


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("n,block", [(64, 16), (96, 32), (70, 32), (257, 64)])
def test_factor_reconstructs_permuted_operand(dtype, n, block):
    A = _rand(n, dtype, seed=n)
    fac = factor_lu(A, block=block)
    PA = np.asarray(A)[np.asarray(fac.perm)]
    err = np.linalg.norm(_reconstruct(fac, n) - PA) / np.linalg.norm(PA)
    assert err < 1e-13, f"LU reconstruction error {err}"
    # perm is a permutation
    assert sorted(np.asarray(fac.perm).tolist()) == list(range(n))


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_solve_matches_dense_oracle(dtype):
    n = 160
    A = _rand(n, dtype, seed=3)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(n)
    if "complex" in dtype:
        b = b + 1j * rng.standard_normal(n)
    b = jnp.asarray(b, dtype)
    fac = factor_lu(A, block=32)
    x = solve_lu(fac, b, block=64)
    x_ref = np.linalg.solve(np.asarray(A), np.asarray(b))
    err = np.linalg.norm(np.asarray(x) - x_ref) / np.linalg.norm(x_ref)
    assert err < 1e-10, f"solve error {err}"


def test_solve_multi_rhs_and_vector_shapes():
    n, k = 96, 5
    A = _rand(n, "complex128", seed=9)
    rng = np.random.default_rng(10)
    B = jnp.asarray(rng.standard_normal((n, k))
                    + 1j * rng.standard_normal((n, k)), "complex128")
    fac = factor_lu(A, block=32)
    X = solve_lu(fac, B, block=32)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(X) - np.asarray(B))
    assert res / np.linalg.norm(np.asarray(B)) < 1e-12
    x0 = solve_lu(fac, B[:, 0], block=32)
    assert np.allclose(np.asarray(x0), np.asarray(X)[:, 0])


def test_pivoting_engages_on_adversarial_operand():
    # leading zero pivot: unpivoted LU dies, partial pivoting sails through
    n = 48
    A = np.asarray(_rand(n, "float64", seed=7), np.float64).copy()
    A[0, 0] = 0.0
    A = jnp.asarray(A)
    fac = factor_lu(A, block=16)
    b = jnp.asarray(np.random.default_rng(8).standard_normal(n))
    x = solve_lu(fac, b, block=16)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(x) - np.asarray(b))
    assert res < 1e-11
    assert int(np.asarray(fac.perm)[0]) != 0   # the pivot actually moved


def test_backward_error_illconditioned():
    # kappa=1e10 in f64: backward error must stay ~machine-eps-grade, the
    # property a reduced-precision internal update would lose
    n = 200
    A = _rand(n, "float64", seed=11, cond=1e10)
    rng = np.random.default_rng(12)
    b = jnp.asarray(rng.standard_normal(n))
    fac = factor_lu(A, block=64)
    x = solve_lu(fac, b, block=64)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(x) - np.asarray(b)) / (
        np.linalg.norm(np.asarray(A)) * np.linalg.norm(np.asarray(x)))
    assert res < 1e-13, f"backward error {res}"


def test_butterfly_is_unitary_and_adjoint_inverts():
    from maus_tpu.ops.blocked_lu import _butterfly_apply, _rand_unit_diags

    n, depth = 64, 2
    key = jax.random.PRNGKey(5)
    diags = _rand_unit_diags(key, depth, n, jnp.complex128)
    rng = np.random.default_rng(6)
    X = jnp.asarray(rng.standard_normal((n, 3))
                    + 1j * rng.standard_normal((n, 3)), jnp.complex128)
    W = _butterfly_apply(X, diags, transpose=False, conj=False)
    # norms preserved (unitary)
    assert np.allclose(np.linalg.norm(np.asarray(W), axis=0),
                       np.linalg.norm(np.asarray(X), axis=0))
    # Wᴴ W = I
    back = _butterfly_apply(W, diags, transpose=True, conj=True)
    assert np.allclose(np.asarray(back), np.asarray(X), atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("n,block", [(128, 32), (96, 32), (200, 64)])
def test_rbt_lu_solves_dense_oracle(dtype, n, block):
    from maus_tpu.ops.blocked_lu import factor_rbt_lu, solve_rbt_lu

    A = _rand(n, dtype, seed=n + 1)
    rng = np.random.default_rng(2 * n)
    B = rng.standard_normal((n, 3))
    if "complex" in dtype:
        B = B + 1j * rng.standard_normal((n, 3))
    B = jnp.asarray(B, dtype)
    fac = factor_rbt_lu(A, block=block)
    X = solve_rbt_lu(fac, B)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(X) - np.asarray(B)) / \
        np.linalg.norm(np.asarray(B))
    assert res < 1e-11, f"RBT-LU residual {res}"
    x0 = solve_rbt_lu(fac, B[:, 0])
    assert np.allclose(np.asarray(x0), np.asarray(X)[:, 0])


def test_rbt_lu_zero_pivot_and_illconditioned():
    from maus_tpu.ops.blocked_lu import factor_rbt_lu, solve_rbt_lu

    # leading zero pivot (kills unpivoted LU without the transform) and
    # kappa=1e8: backward error must stay eps-grade w.h.p.
    n = 160
    A = np.array(_rand(n, "complex128", seed=21, cond=1e8), np.complex128)
    A[0, 0] = 0.0
    rng = np.random.default_rng(22)
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    fac = factor_rbt_lu(jnp.asarray(A), block=32)
    x = solve_rbt_lu(fac, b)
    res = np.linalg.norm(A @ np.asarray(x) - np.asarray(b)) / (
        np.linalg.norm(A) * np.linalg.norm(np.asarray(x)))
    assert res < 1e-12, f"RBT-LU backward error {res}"


def test_rbt_lu_under_jit():
    from maus_tpu.ops.blocked_lu import factor_rbt_lu, solve_rbt_lu

    n = 128
    A = _rand(n, "complex128", seed=31)
    rng = np.random.default_rng(32)
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    fac = jax.jit(lambda a: factor_rbt_lu(a, block=32))(A)
    x = jax.jit(solve_rbt_lu)(fac, b)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(x) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))
    assert res < 1e-11


def test_facplanes_roundtrip_keeps_int_perm():
    # FacPlanes (ops/refine.py) splits complex factor leaves into planes for
    # large-N refinement; BlockedLU/RBTLU carry an int32 perm that must ride
    # through combine() unchanged (lax.complex on it would manufacture a
    # complex permutation)
    from maus_tpu.ops.blocked_lu import factor_rbt_lu, solve_rbt_lu
    from maus_tpu.ops.refine import fac_to_planes

    n = 96
    A = _rand(n, "complex128", seed=41)
    rng = np.random.default_rng(42)
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    fac = factor_rbt_lu(A, block=32)
    fac2 = fac_to_planes(fac).combine()
    assert fac2.perm.dtype == jnp.int32
    x = solve_rbt_lu(fac2, b)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(x) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))
    assert res < 1e-11


def test_facplanes_roundtrip_keeps_real_float_leaves():
    # VERDICT r4 weak #4: a factorization with GENUINELY REAL float leaves
    # (e.g. a real-operand QR) must come back from combine() with its dtype
    # preserved — the old combine() lax.complex'd every floating leaf, so a
    # real f64 Q came back complex
    from maus_tpu.ops.batched_solve import factor_qr, solve_qr
    from maus_tpu.ops.refine import fac_to_planes

    n = 64
    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.standard_normal((n, n)))          # real f64
    b = jnp.asarray(rng.standard_normal(n))
    fac = factor_qr(A)
    fac2 = fac_to_planes(fac).combine()
    assert fac2.q.dtype == fac.q.dtype == jnp.float64
    assert fac2.r.dtype == fac.r.dtype == jnp.float64
    np.testing.assert_array_equal(np.asarray(fac2.q), np.asarray(fac.q))
    x = solve_qr(fac2, b)
    res = np.linalg.norm(np.asarray(A) @ np.asarray(x) - np.asarray(b)) / \
        np.linalg.norm(np.asarray(b))
    assert res < 1e-12
    # mixed real/complex trees: complex leaves still recombine exactly
    Ac = _rand(n, "complex128", seed=8)
    facc = factor_qr(Ac)
    facc2 = fac_to_planes(facc).combine()
    assert jnp.issubdtype(facc2.q.dtype, jnp.complexfloating)
    np.testing.assert_array_equal(np.asarray(facc2.q), np.asarray(facc.q))


def test_jit_and_c64():
    n = 128
    A = _rand(n, "complex64", seed=13)
    fac = jax.jit(lambda a: factor_lu(a, block=32))(A)
    PA = np.asarray(A, np.complex128)[np.asarray(fac.perm)]
    err = np.linalg.norm(_reconstruct(fac, n) - PA) / np.linalg.norm(PA)
    assert err < 5e-6, f"c64 reconstruction error {err}"
