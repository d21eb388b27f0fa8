"""Gradients through the plain verbs: the routed path, the sequential
scan and central finite differences agree (KF, UKF, EKF, PF with a
fixed key), and forward-mode works through the scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf

A2 = jnp.array([[0.97, -0.09], [0.09, 0.97]])
B2 = jnp.array([[0.1], [0.0]])


def _kf(s):
    return llpf.KalmanFilter(A2, B2, jnp.eye(2), 0, s * jnp.eye(2),
                             0.1 * jnp.eye(2))


def _ukf(s):
    return llpf.make_ukf(lambda x, u, p, t: A2 @ x + 0.01 * jnp.sin(x),
                         lambda x, u, p, t: x, s * jnp.eye(2),
                         0.1 * jnp.eye(2), ny=2, nu=0)


def _ekf(s):
    return llpf.make_ekf(lambda x, u, p, t: A2 @ x + 0.01 * jnp.sin(x),
                         lambda x, u, p, t: x, s * jnp.eye(2),
                         0.1 * jnp.eye(2), ny=2, nu=0)


@pytest.fixture(scope="module")
def data():
    _, u, y = llpf.simulate(_kf(0.01), 0.3 * jnp.ones((80, 1)),
                            jax.random.PRNGKey(0))
    return u, y


def _fd(f, s, eps=1e-5):
    return (f(s + eps) - f(s - eps)) / (2 * eps)


@pytest.mark.parametrize("make,use_u,methods", [
    (_kf, True, ("auto", "sequential", "parallel")),
    (_ukf, False, ("auto", "sequential", "parallel")),
    (_ekf, False, ("auto", "sequential", "parallel")),
], ids=["kf", "ukf", "ekf"])
def test_grad_routes_vs_fd(data, make, use_u, methods):
    u, y = data
    u = u if use_u else None
    grads = {}
    for m in methods:
        f = lambda s, m=m: llpf.loglik(make(s), u, y, method=m)
        grads[m] = float(jax.grad(f)(0.01))
    fd = float(_fd(lambda s: llpf.loglik(make(s), u, y,
                                         method="sequential"), 0.01))
    for m, g in grads.items():
        assert abs(g - fd) < 1e-5 * (1.0 + abs(fd)), (m, g, fd)


def test_forward_trajectory_grad(data):
    u, y = data
    f = lambda s: jnp.sum(llpf.forward_trajectory(_ukf(s), None, y).xt ** 2)
    g = float(jax.grad(f)(0.01))
    assert abs(g - float(_fd(f, 0.01))) < 1e-5 * (1.0 + abs(g))


def test_pf_grad_fixed_key_matches_fd(data):
    """With a fixed key and no resampling the PF loglik is a smooth
    function of the measurement-noise scale."""
    u, y = data

    def f(s):
        pf = llpf.ParticleFilter(
            N=256, dynamics=lambda x, u_, p, t: A2 @ x + B2 @ u_,
            measurement=lambda x, u_, p, t: x,
            dynamics_density=0.01 * jnp.eye(2),
            measurement_density=s * jnp.eye(2),
            initial_density=0.01 * jnp.eye(2), resample_threshold=0.0)
        return llpf.loglik(pf, u, y, key=jax.random.PRNGKey(1))

    g = float(jax.grad(f)(0.1))
    assert abs(g - float(_fd(f, 0.1))) < 1e-4 * (1.0 + abs(g))


def test_jacfwd_through_scan(data):
    u, y = data
    f = lambda s: llpf.loglik(_ekf(s), None, y)
    np.testing.assert_allclose(float(jax.jacfwd(f)(0.01)),
                               float(jax.grad(f)(0.01)), rtol=1e-8)
