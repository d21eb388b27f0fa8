"""Quadtank example: nonlinear state estimation with UKF / EKF / PF.

JAX rendition of the reference's examples/example_quadtank.jl —
the standard four-tank laboratory process (Johansson 2000), a textbook
nonlinear benchmark: four coupled tanks with square-root outflows and two
pumps feeding diagonally opposite pairs.

Demonstrates: RK4 discretization (`llpf.rk4`), UKF vs EKF vs a bootstrap
PF on the same model, RTS smoothing, and gradient-based tuning of the
process-noise scale — everything jit-compiled end to end.

Run: ``python examples/example_quadtank.py``
"""
import jax

try:  # fall back to CPU when no accelerator backend is usable
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import lowlevelparticlefilters_jl_tpu as llpf

# --- model ----------------------------------------------------------------
K1, K2, G = 1.6, 1.6, 9.81
AREA = 4.9
OUTLET = 0.03
GAMMA1, GAMMA2 = 0.3, 0.3
TS = 2.0


def ssqrt(x):
    """Smooth sqrt that tolerates slightly negative tank levels."""
    return jnp.sqrt(jnp.maximum(x, 1e-6))


def quadtank(h, u, p, t):
    a, A = OUTLET, AREA
    q1 = ssqrt(2 * G * h[0])
    q2 = ssqrt(2 * G * h[1])
    q3 = ssqrt(2 * G * h[2])
    q4 = ssqrt(2 * G * h[3])
    return jnp.array([
        -a / A * q1 + a / A * q3 + GAMMA1 * K1 / A * u[0],
        -a / A * q2 + a / A * q4 + GAMMA2 * K2 / A * u[1],
        -a / A * q3 + (1 - GAMMA2) * K2 / A * u[1],
        -a / A * q4 + (1 - GAMMA1) * K1 / A * u[0],
    ])


dynamics = llpf.rk4(quadtank, TS, supersample=2)


def measurement(x, u, p, t):
    return x[:2]  # levels of the two lower tanks


# --- joint state + fault-parameter estimation ------------------------------
def quadtank_leak(h, u, p, t, a1):
    """Quadtank with a distinct tank-1 outlet area ``a1`` (the fault
    channel of example_quadtank.jl:56-71)."""
    a, A = OUTLET, AREA
    q1 = ssqrt(2 * G * h[0])
    q2 = ssqrt(2 * G * h[1])
    q3 = ssqrt(2 * G * h[2])
    q4 = ssqrt(2 * G * h[3])
    return jnp.array([
        -a1 / A * q1 + a / A * q3 + GAMMA1 * K1 / A * u[0],
        -a / A * q2 + a / A * q4 + GAMMA2 * K2 / A * u[1],
        -a / A * q3 + (1 - GAMMA2) * K2 / A * u[1],
        -a / A * q4 + (1 - GAMMA1) * K1 / A * u[0],
    ])


def quadtank_aug(s, u, p, t):
    """Augmented 5-state model: [h1..h4, a1], the outlet area carried as
    a random-walk state (example_quadtank.jl:56-88 — joint estimation /
    online fault detection)."""
    return jnp.concatenate([quadtank_leak(s[:4], u, p, t, s[4]),
                            jnp.zeros(1)])


dynamics_aug = llpf.rk4(quadtank_aug, TS, supersample=2)


def fault_estimation(T=500, t_fault=250):
    """Track a doubled tank-1 outlet (0.03 → 0.06 at ``t_fault``) online
    with an augmented-state UKF, mirroring the reference's asserts
    (example_quadtank.jl:84-86: â1 ≈ 0.03 before, ≈ 0.06 after)."""
    key = jax.random.PRNGKey(0)
    t = jnp.arange(T)
    us = 0.25 * (jnp.sign(jnp.sin(2 * jnp.pi * t / 100.0))[:, None]
                 * jnp.ones((1, 2))) + 0.25

    a1_true = jnp.where(t >= t_fault, 2 * OUTLET, OUTLET)

    def step(h, inp):
        u, a1 = inp
        hn = llpf.rk4(lambda hh, uu, pp, tt: quadtank_leak(hh, uu, pp, tt, a1),
                      TS, supersample=2)(h, u, None, 0.0)
        return hn, h

    _, hs = jax.lax.scan(step, jnp.array([2.0, 2.0, 3.0, 3.0]), (us, a1_true))
    ys = hs[:, :2] + 0.01 * jax.random.normal(key, (T, 2))

    R1a = jnp.diag(jnp.array([1e-4, 1e-4, 1e-4, 1e-4, 1e-7]))
    ukf = llpf.make_ukf(
        dynamics_aug, measurement, R1a, 1e-4 * jnp.eye(2),
        d0=llpf.MvNormal(jnp.array([2.0, 2.0, 3.0, 3.0, 0.02]),
                         jnp.diag(jnp.array([1.0, 1.0, 1.0, 1.0, 1e-4]))),
        nu=2, ny=2, Ts=TS)
    sol = llpf.forward_trajectory(ukf, us, ys)
    a1_est = sol.xt[:, 4]
    pre = float(a1_est[t_fault - 10])
    post = float(a1_est[-1])
    print(f"a1 estimate: pre-fault {pre:.4f} (true {OUTLET}), "
          f"post-fault {post:.4f} (true {2 * OUTLET})")
    return sol, a1_est, pre, post


def main():
    nx, nu, ny = 4, 2, 2
    R1 = 1e-4 * jnp.eye(nx)
    R2 = 1e-2 * jnp.eye(ny)
    x0 = jnp.array([2.0, 2.0, 1.0, 1.0])
    d0 = llpf.MvNormal(x0, jnp.eye(nx))

    T = 300
    key = jax.random.PRNGKey(0)
    us = 0.25 * (
        1 + jnp.stack([jnp.sign(jnp.sin(2 * jnp.pi * jnp.arange(T) / 100.0)),
                       jnp.sign(jnp.cos(2 * jnp.pi * jnp.arange(T) / 140.0))], -1)
    )

    ukf = llpf.make_ukf(dynamics, measurement, R1, R2, d0=d0, nu=nu, ny=ny, Ts=TS)
    ekf = llpf.make_ekf(dynamics, measurement, R1, R2, d0=d0, nu=nu, ny=ny, Ts=TS)
    xs, us, ys = llpf.simulate(ukf, us, key)

    sol_ukf = llpf.forward_trajectory(ukf, us, ys)
    sol_ekf = llpf.forward_trajectory(ekf, us, ys)
    ssol = llpf.smooth(ukf, us, ys)

    pf = llpf.ParticleFilter(
        N=5000, dynamics=dynamics, measurement=measurement,
        dynamics_density=R1, measurement_density=R2, initial_density=d0,
    )
    sol_pf = llpf.forward_trajectory(pf, us, ys, key=jax.random.PRNGKey(1))

    def rmse(est):
        return float(jnp.sqrt(jnp.mean((est - xs) ** 2)))

    print(f"UKF  ll={float(sol_ukf.ll):10.2f}  rmse={rmse(sol_ukf.xt):.4f}")
    print(f"EKF  ll={float(sol_ekf.ll):10.2f}  rmse={rmse(sol_ekf.xt):.4f}")
    print(f"RTS                     rmse={rmse(ssol.xT):.4f}")
    m_pf = llpf.mean_trajectory(sol_pf.x, sol_pf.we)
    print(f"PF   ll={float(sol_pf.ll):10.2f}  rmse={rmse(m_pf):.4f}")

    # gradient-based noise tuning through the UKF scan
    g = jax.grad(
        lambda s: -llpf.loglik(ukf.replace(R1=s * jnp.eye(nx)), us, ys)
    )(1e-4)
    print(f"d(-loglik)/dR1scale = {float(g):.2f}")
    return sol_ukf, sol_ekf, ssol, sol_pf, xs


if __name__ == "__main__":
    main()
