"""Temporal-parallel associative scans: plane (per-entry [T] leaves) form
against the array ([T, n, n]) form, forward and reverse, and the whole
parallel filter/smoother against the sequential Kalman recursion.

Kept at nx <= 2 and T <= 512: the unrolled plane graphs compile slowly
on the CPU backend at larger state dimensions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.parallel import temporal as tp


def _model(nx, T, seed=0):
    rng = np.random.default_rng(seed)
    F = np.tile(0.9 * np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)),
                (T, 1, 1))
    c = 0.1 * rng.standard_normal((T, nx))
    H = np.tile(np.eye(nx), (T, 1, 1))
    Q = np.tile(0.05 * np.eye(nx), (T, 1, 1))
    R = np.tile(0.2 * np.eye(nx), (T, 1, 1))
    y = rng.standard_normal((T, nx))
    m0, P0 = np.zeros(nx), np.eye(nx)
    return tuple(jnp.asarray(a) for a in (F, c, H, Q, R, y, m0, P0))


@pytest.mark.parametrize("nx,T", [(1, 37), (2, 200), (2, 512)])
def test_filter_scan_plane_vs_array(nx, T):
    F, c, H, Q, R, y, m0, P0 = _model(nx, T)
    elems = tp._filter_elements(F, c, H, Q, R, y, m0, P0)
    _, b_a, C_a, _, _ = jax.lax.associative_scan(tp._filter_combine, elems)
    elems_p = (tp._m_split(elems[0]), tp._v_split(elems[1]),
               tp._m_split(elems[2]), tp._v_split(elems[3]),
               tp._m_split(elems[4]))
    b_p, C_p = tp._scan_filter_p(elems_p)
    np.testing.assert_allclose(np.stack(b_p, -1), b_a, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(tp._m_join(C_p), C_a, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("nx,T", [(1, 37), (2, 200)])
def test_smooth_scan_plane_vs_array_reverse(nx, T):
    F, c, H, Q, R, y, m0, P0 = _model(nx, T, seed=1)
    _, _, xt, Rt, *_ = tp._parallel_filter_core_arrays(F, c, H, Q, R, y,
                                                       m0, P0)
    E, g, L = tp._smooth_elements(F, c, Q, xt, Rt)
    _, g_a, L_a = jax.lax.associative_scan(
        lambda a, b: tp._smooth_combine(b, a), (E, g, L), reverse=True)
    g_p, L_p = tp._parallel_smooth_core_p(
        tp._m_split(F), tp._v_split(c), tp._m_split(Q), tp._v_split(xt),
        tp._m_split(Rt), T)
    np.testing.assert_allclose(np.stack(g_p, -1), g_a, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(tp._m_join(L_p), L_a, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("nx,T", [(1, 64), (2, 300)])
def test_filter_core_plane_vs_array(nx, T):
    args = _model(nx, T, seed=2)
    plane = tp._parallel_filter_core(*args)
    arr = tp._parallel_filter_core_arrays(*args)
    for a, b in zip(plane, arr):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-9),
                                       (jnp.float32, 1e-4)])
def test_parallel_kf_and_rts_match_sequential(dtype, tol):
    A = jnp.array([[0.97, -0.09], [0.09, 0.97]], dtype)
    B = jnp.array([[0.1], [0.0]], dtype)
    kf = llpf.KalmanFilter(A, B, jnp.eye(2, dtype=dtype), 0,
                           0.01 * jnp.eye(2, dtype=dtype),
                           0.1 * jnp.eye(2, dtype=dtype))
    _, u, y = llpf.simulate(kf, 0.3 * jnp.ones((256, 1), dtype),
                            jax.random.PRNGKey(0))
    seq = llpf.smooth(kf, u, y, method="sequential")
    par = jax.jit(lambda u_, y_: llpf.smooth(kf, u_, y_,
                                             method="parallel"))(u, y)
    np.testing.assert_allclose(par.sol.xt, seq.sol.xt, atol=tol)
    np.testing.assert_allclose(par.xT, seq.xT, atol=tol)
    np.testing.assert_allclose(par.RT, seq.RT, atol=tol)
    assert abs(float(par.sol.ll) - float(seq.sol.ll)) < tol * abs(
        float(seq.sol.ll)) * 10


def test_parallel_filter_grad_matches_sequential():
    A = jnp.array([[0.97, -0.09], [0.09, 0.97]])
    kf = llpf.KalmanFilter(A, None, jnp.eye(2), 0, 0.01 * jnp.eye(2),
                           0.1 * jnp.eye(2))
    y = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (128, 2))
    g = lambda m: jax.grad(lambda s: llpf.loglik(
        kf.replace(R1=s * jnp.eye(2)), None, y, method=m))(0.02)
    assert abs(float(g("parallel")) - float(g("sequential"))) < 1e-6 * (
        1.0 + abs(float(g("sequential"))))
