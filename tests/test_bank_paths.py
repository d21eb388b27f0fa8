"""KF bank execution paths: the prefix-composed plane path, the
bank-major array scan and ``vmap(loglik)`` agree; odd bank sizes; the
general (R12 / alpha) shared recursion; the removed kernel method."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.filters.bank import (
    _bank_inputs, _bank_loglik_planes, _bank_scan, _shared_recursion)

A = jnp.array([[0.97, -0.1], [0.1, 0.97]], jnp.float32)
B = jnp.array([[0.1], [0.0]], jnp.float32)
C = jnp.array([[1.0, 0.0], [0.2, 1.0]], jnp.float32)
D = jnp.array([[0.05], [0.0]], jnp.float32)
R1 = 0.01 * jnp.eye(2, dtype=jnp.float32)
R2 = 0.1 * jnp.eye(2, dtype=jnp.float32)


def _kf(nu=1, **kw):
    kw.setdefault("d0", llpf.MvNormal(jnp.array([0.1, -0.2], jnp.float32),
                                      0.5 * jnp.eye(2, dtype=jnp.float32)))
    return llpf.KalmanFilter(A, B if nu else None, C, D if nu else 0, R1, R2,
                             **kw)


def _data(Bk, T, key=0, nu=1):
    ku, ky = jax.random.split(jax.random.PRNGKey(key))
    us = 0.3 * jax.random.normal(ku, (Bk, T, nu), jnp.float32)
    ys = jax.random.normal(ky, (Bk, T, 2), jnp.float32)
    return us, ys


def _vmap_ll(kf, us, ys):
    return jax.vmap(lambda u, y: llpf.loglik(kf, u, y,
                                             method="sequential"))(us, ys)


def _array_ll(kf, us, ys):
    """The bank-major array scan (the path above the plane bound)."""
    ll, *_ = _bank_scan(kf, us, ys, want_states=True)
    return ll


def _plane_ll(kf, us, ys):
    us, ys, Bk, T = _bank_inputs(kf, us, ys)
    _, Schol, K, _, Am, Bm, Cm, Dm = _shared_recursion(kf, T, ys.dtype)
    return _bank_loglik_planes(kf, us, ys, Bk, T, ys.dtype, Schol, K, Am,
                               Bm, Cm, Dm)


@pytest.mark.parametrize("nu", [1, 0])
@pytest.mark.parametrize("Bk,T", [(8, 40), (13, 33)])
def test_plane_array_vmap_agree(nu, Bk, T):
    kf = _kf(nu)
    us, ys = _data(Bk, T, key=Bk + nu, nu=max(nu, 1))
    if not nu:
        us = None
    want = np.asarray(_vmap_ll(kf, us if nu else jnp.zeros((Bk, T, 0)), ys))
    np.testing.assert_allclose(np.asarray(_plane_ll(kf, us, ys)), want,
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(_array_ll(kf, us, ys)), want,
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(llpf.kf_bank_loglik(kf, us, ys)),
                               want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("kw", [
    {"R12": jnp.array([[0.01, 0.0], [0.0, 0.005]], jnp.float32)},
    {"alpha": 1.02}], ids=["r12", "alpha"])
def test_general_recursion_matches_vmap(kw):
    kf = _kf(**kw)
    us, ys = _data(4, 15, key=5)
    np.testing.assert_allclose(np.asarray(llpf.kf_bank_loglik(kf, us, ys)),
                               np.asarray(_vmap_ll(kf, us, ys)),
                               rtol=2e-5, atol=1e-4)


def test_bank_grad_matches_vmap():
    us, ys = _data(6, 20, key=7)

    def loss(s, fn):
        return -jnp.sum(fn(_kf().replace(R1=s * jnp.eye(2, dtype=jnp.float32)),
                           us, ys))

    g_bank = jax.grad(loss)(jnp.float32(0.01), llpf.kf_bank_loglik)
    g_vmap = jax.grad(loss)(jnp.float32(0.01), _vmap_ll)
    assert abs(float(g_bank) - float(g_vmap)) < 1e-3 * abs(float(g_vmap))


@pytest.mark.parametrize("method", ["auto", "plane"])
def test_methods_accepted(method):
    us, ys = _data(3, 10, key=8)
    ll = llpf.kf_bank_loglik(_kf(), us, ys, method=method)
    assert ll.shape == (3,)


def test_kernel_method_removed():
    us, ys = _data(3, 10, key=9)
    with pytest.raises(ValueError, match="removed"):
        llpf.kf_bank_loglik(_kf(), us, ys, method="kernel")
