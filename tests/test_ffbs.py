"""FFBS particle smoother (``ffbs_smooth``, the XLA backward scan): every
returned state is one of the forward particles of its step, and the
smoothed mean agrees with the exact RTS mean within Monte-Carlo error."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf

A = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]], jnp.float32)
B = jnp.array([[0.1], [0.0]], jnp.float32)
R1 = 0.01 * jnp.eye(2, dtype=jnp.float32)
R2 = 0.1 * jnp.eye(2, dtype=jnp.float32)


class _NotMvNormal:
    """A density object that is not an ``MvNormal``: takes the generic
    broadcast form of the backward weights."""

    def __init__(self, d):
        self.d, self.dim = d, d.dim

    def logpdf(self, x):
        return self.d.logpdf(x)

    def sample(self, key, shape=()):
        return self.d.sample(key, shape)


def _pf(N, dyn_density=R1):
    return llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: x, dynamics_density=dyn_density,
        measurement_density=R2, initial_density=R1)


@pytest.fixture(scope="module")
def data():
    kf = llpf.KalmanFilter(A, B, jnp.eye(2, dtype=jnp.float32), 0, R1, R2)
    _, u, y = llpf.simulate(kf, 0.3 * jnp.ones((15, 1), jnp.float32),
                            jax.random.PRNGKey(0))
    return kf, u, y


def _smooth(pf, u, y, M):
    sol = pf.forward_trajectory(u, y, key=jax.random.PRNGKey(1))
    xb, ll = llpf.ffbs_smooth(pf, sol, M, jax.random.PRNGKey(2))
    return sol, np.asarray(xb), ll


@pytest.mark.parametrize("gaussian", [True, False],
                         ids=["gaussian", "generic_density"])
def test_rows_are_forward_particles(data, gaussian):
    _, u, y = data
    dens = R1 if gaussian else _NotMvNormal(llpf.MvNormal(
        jnp.zeros(2, jnp.float32), R1))
    sol, xb, ll = _smooth(_pf(512, dens), u, y, 64)
    xf = np.asarray(sol.x)
    assert xb.shape == (y.shape[0], 64, 2)
    assert np.isfinite(float(ll))
    for t in range(y.shape[0]):
        hit = (xb[t][:, None, :] == xf[t][None, :, :]).all(-1).any(-1)
        assert hit.all(), t


def test_mean_within_mc_error_of_rts(data):
    kf, u, y = data
    M = 400
    _, xb, _ = _smooth(_pf(4096), u, y, M)
    xT = np.asarray(llpf.smooth(kf, u, y).xT)
    se = xb.std(axis=1) / np.sqrt(M)
    assert np.max(np.abs(xb.mean(axis=1) - xT) / se) < 5.0


def test_backend_option_removed(data):
    _, u, y = data
    pf = _pf(64)
    sol = pf.forward_trajectory(u, y, key=jax.random.PRNGKey(1))
    with pytest.raises(TypeError, match="backend"):
        llpf.ffbs_smooth(pf, sol, 8, jax.random.PRNGKey(2), backend="pallas")
