"""Parameter (`p`) threading tests, mirroring
/root/reference/test/test_parameters.jl: the SciML-style parameter object
stored on the filter flows into every dynamics/measurement call, and a
per-call override replaces it consistently through simulate /
forward_trajectory / loglik — plus the JAX extra: `p` is a pytree
leaf you can differentiate and vmap over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf

A = jnp.array([[0.99, 0.1], [0.0, 0.2]])
B = jnp.array([[0.3, -0.7], [0.9, 0.2]])


def dyn(x, u, p, t):
    return A @ x + B @ u + p


def meas(x, u, p, t):
    return x


@pytest.fixture(scope="module")
def filt():
    return llpf.make_ukf(dyn, meas, 0.01 * jnp.eye(2), jnp.eye(2),
                         d0=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)),
                         nu=2, ny=2, p=1.0)


def test_stored_p_and_override(filt):
    """Filtering data generated with p=-1 only works when the override is
    passed (test_parameters.jl:27-33)."""
    us = jax.random.normal(jax.random.PRNGKey(0), (20, 2))
    x1, u1, y1 = llpf.simulate(filt, us, jax.random.PRNGKey(1))          # p=1
    x2, u2, y2 = llpf.simulate(filt, us, jax.random.PRNGKey(1), p=-1.0)  # p=-1
    # trajectories actually differ with the parameter
    assert float(jnp.max(jnp.abs(x1 - x2))) > 0.5

    ll_matched1 = float(llpf.loglik(filt, u1, y1))
    ll_matched2 = float(llpf.loglik(filt, u2, y2, p=-1.0))
    ll_mismatched = float(llpf.loglik(filt, u2, y2))  # wrong stored p=1
    assert ll_matched1 > -100
    assert ll_matched2 > -100
    assert ll_mismatched < ll_matched2  # fails if p isn't adjusted


def test_p_as_pytree(filt):
    """`p` may be an arbitrary pytree (dict) consumed by the callbacks."""
    def dyn_d(x, u, p, t):
        return A @ x + B @ u + p["bias"]

    ukf = llpf.make_ukf(dyn_d, meas, 0.01 * jnp.eye(2), jnp.eye(2),
                        d0=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)),
                        nu=2, ny=2, p={"bias": jnp.array([0.5, -0.5])})
    us = jnp.zeros((15, 2))
    _, _, ys = llpf.simulate(ukf, us, jax.random.PRNGKey(2))
    sol = llpf.forward_trajectory(ukf, us, ys)
    assert np.isfinite(float(sol.ll))


def test_grad_wrt_p(filt):
    """Differentiate the loglik w.r.t. the parameter — the gradient-based
    parameter-estimation path the reference reaches via ForwardDiff."""
    us = jax.random.normal(jax.random.PRNGKey(3), (20, 2))
    _, u1, y1 = llpf.simulate(filt, us, jax.random.PRNGKey(4), p=0.3)

    nll = lambda p: -llpf.loglik(filt, u1, y1, p=p)
    g = jax.grad(nll)(0.0)
    assert np.isfinite(float(g))
    # the minimizer is near the generating value 0.3: gradient points down
    assert float(nll(0.3)) < float(nll(0.0))


def test_vmap_over_p(filt):
    """A bank of parameter hypotheses evaluated in one batched pass —
    the batched replacement for parameter sweeps."""
    us = jax.random.normal(jax.random.PRNGKey(5), (15, 2))
    _, u1, y1 = llpf.simulate(filt, us, jax.random.PRNGKey(6), p=0.5)
    ps = jnp.linspace(-1.0, 1.5, 11)
    lls = jax.vmap(lambda p: llpf.loglik(filt, u1, y1, p=p))(ps)
    best = float(ps[jnp.argmax(lls)])
    assert abs(best - 0.5) <= 0.25  # grid resolution


def test_pytree_inputs():
    """Control inputs may be arbitrary pytrees (the reference allows any
    per-step u object, test_ukf.jl custom-u): `lax.scan` slices pytree xs
    natively, so dict-valued u flows through forward_trajectory/loglik."""
    def dyn_u(x, u, p, t):
        return A @ x + u["force"] * u["gain"]

    ukf = llpf.make_ukf(dyn_u, meas, 0.01 * jnp.eye(2), jnp.eye(2),
                        d0=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)),
                        nu=2, ny=2)
    T = 15
    u_tree = {
        "force": jax.random.normal(jax.random.PRNGKey(7), (T, 2)),
        "gain": jnp.ones((T,)) * 0.5,
    }
    # matched flat-u filter as oracle
    def dyn_flat(x, u, p, t):
        return A @ x + 0.5 * u

    ukf_flat = llpf.make_ukf(dyn_flat, meas, 0.01 * jnp.eye(2), jnp.eye(2),
                             d0=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)),
                             nu=2, ny=2)
    ys = jax.random.normal(jax.random.PRNGKey(8), (T, 2)) * 0.5
    sol_tree = llpf.forward_trajectory(ukf, u_tree, ys)
    sol_flat = llpf.forward_trajectory(ukf_flat, u_tree["force"], ys)
    np.testing.assert_allclose(
        np.asarray(sol_tree.xt), np.asarray(sol_flat.xt), atol=1e-10
    )
    ll = llpf.loglik(ukf, u_tree, ys)
    np.testing.assert_allclose(float(ll), float(sol_flat.ll), rtol=1e-10)


class TestDiffAllFilters:
    """test_diff.jl: one predict+correct of KF/UKF/SqKF/EKF must be
    differentiable w.r.t. R1 scale, R2 scale, and a dynamics parameter;
    gradients checked finite and against central finite differences."""

    _A = jnp.array([[0.99, 0.1], [0.0, 0.2]])
    _B = jnp.array([[-0.74, 1.61], [-1.44, 1.75]])

    def _filters(self, r1, r2, p=None):
        A, B = self._A, self._B
        C = jnp.eye(2)
        R1 = r1 * jnp.eye(2)
        R2 = r2 * jnp.eye(2)
        d0 = llpf.MvNormal(jnp.zeros(2), jnp.eye(2))
        dyn3 = lambda x, u, pp, t: A @ x + B @ u + (pp if pp is not None else 0.0)
        me3 = lambda x, u, pp, t: x + (pp if pp is not None else 0.0)
        return (
            llpf.KalmanFilter(A, B, C, 0, R1, R2, d0=d0),
            llpf.make_ukf(dyn3, me3, R1, R2, d0=d0, nu=2, ny=2, p=p),
            llpf.SqKalmanFilter(A, B, C, 0, R1, R2, d0=d0),
            llpf.make_ekf(dyn3, me3, R1, R2, d0=d0, nu=2, ny=2, p=p),
        )

    def _cost(self, r1, r2, p=None):
        u0 = jnp.array([0.3, -0.2])
        y0 = jnp.array([0.5, 0.1])
        out = 0.0
        for f in self._filters(r1, r2, p):
            s = f.predict(f.init(), u0)
            s, info = f.correct(s, u0, y0, p)
            out = out - info.ll + jnp.sum(info.e)
        return out

    @pytest.mark.parametrize("which", ["R1", "R2", "p"])
    def test_grad_matches_fd(self, which):
        if which == "R1":
            f = lambda th: self._cost(th, 1.0)
        elif which == "R2":
            f = lambda th: self._cost(1.0, th)
        else:
            f = lambda th: self._cost(1.0, 1.0, th)
        th0 = jnp.asarray(1.0)
        g = jax.grad(f)(th0)
        assert np.isfinite(float(g))
        h = 1e-5
        fd = (f(th0 + h) - f(th0 - h)) / (2 * h)
        np.testing.assert_allclose(float(g), float(fd), rtol=2e-3, atol=1e-4)
