"""Nonlinear filter comparison: UKF vs EKF vs IEKF.

Re-derivation of /root/reference/examples/example_nonlinear_kf.jl for the
JAX framework: two classic nonlinear benchmarks — a bearings-only
tracking problem and the scalar "growth" model — filtered by the UKF, the
EKF, and the iterated EKF, comparing Monte-Carlo RMS state errors.

The reference loops filters and Monte-Carlo runs in Python^W Julia; here
each filter runs its whole trajectory as one `lax.scan` and the N
Monte-Carlo repetitions are one `vmap` — the full experiment is a single
jit.
"""
import jax
import jax.numpy as jnp
import numpy as np

import lowlevelparticlefilters_jl_tpu as llpf


def run_experiment(dynamics, measurement, R1, R2, d0, nx, ny, x0, *,
                   N=20, Tmax=60, steplength=0.5, key=jax.random.PRNGKey(0)):
    """Monte-Carlo RMS error curves for UKF/EKF/IEKF on one system."""
    ukf = llpf.make_ukf(dynamics, measurement, R1, R2, d0=d0, nu=0, ny=ny)
    ekf = llpf.make_ekf(dynamics, measurement, R1, R2, d0=d0, nu=0, ny=ny)
    iekf = llpf.make_iekf(dynamics, measurement, R1, R2, d0=d0, nu=0, ny=ny,
                          step=steplength, maxiters=10)
    dproc = llpf.MvNormal(jnp.zeros(nx), jnp.asarray(R1))
    dmeas = llpf.MvNormal(jnp.zeros(ny), jnp.asarray(R2))

    def one_run(k):
        kx, kw, kv = jax.random.split(k, 3)
        # simulate the true trajectory
        def sim_step(x, inp):
            t, kw_t, kv_t = inp
            xn = dynamics(x, None, None, t) + dproc.sample(kw_t)
            y = measurement(xn, None, None, t) + dmeas.sample(kv_t)
            return xn, (xn, y)

        T = Tmax
        tvec = jnp.arange(T, dtype=jnp.float32)
        _, (xs, ys) = jax.lax.scan(
            sim_step, x0, (tvec, jax.random.split(kw, T), jax.random.split(kv, T))
        )

        def filt_errors(flt):
            st = flt.init()

            def step(st, inp):
                t, y, x_true = inp
                st = flt.predict(st, None, None, t)
                st, _ = flt.correct(st, None, y, None, t)
                return st, jnp.sum((flt.state(st) - x_true) ** 2)

            _, errs = jax.lax.scan(step, st, (tvec, ys, xs))
            return errs

        return filt_errors(ukf), filt_errors(ekf), filt_errors(iekf)

    keys = jax.random.split(key, N)
    ukf_e, ekf_e, iekf_e = jax.jit(jax.vmap(one_run))(keys)
    rms = lambda e: np.sqrt(np.mean(np.asarray(e), axis=0))
    return rms(ukf_e), rms(ekf_e), rms(iekf_e)


def bearings_only(N=20, Tmax=60):
    """System 1: static target, two bearing sensors (example_nonlinear_kf.jl:5-7)."""
    def dynamics(x, u, p, t):
        return x

    def measurement(x, u, p, t):
        return jnp.array([
            jnp.arctan2(x[1] - 1.5, x[0] - 0.0),
            jnp.arctan2(x[1] - 0.0, x[0] - 0.0),
        ])

    R1 = 1e-4 * jnp.eye(2)
    R2 = 5e-3 * jnp.eye(2)
    d0 = llpf.MvNormal(jnp.array([1.2, 0.8]), 0.1 * jnp.eye(2))
    x0 = jnp.array([1.0, 1.0])
    return run_experiment(dynamics, measurement, R1, R2, d0, 2, 2, x0,
                          N=N, Tmax=Tmax)


def growth_model(N=20, Tmax=60):
    """System 2: the scalar growth model (example_nonlinear_kf.jl:8-10)."""
    def dynamics(x, u, p, t):
        return 0.5 * x + 25.0 * x / (1.0 + x**2) + 8.0 * jnp.cos(1.2 * (t - 1.0))

    def measurement(x, u, p, t):
        return x**2 / 20.0

    R1 = 1.0 * jnp.eye(1)
    R2 = 1.0 * jnp.eye(1)
    d0 = llpf.MvNormal(jnp.zeros(1), 2.0 * jnp.eye(1))
    x0 = jnp.array([0.1])
    return run_experiment(dynamics, measurement, R1, R2, d0, 1, 1, x0,
                          N=N, Tmax=Tmax, steplength=0.5)


if __name__ == "__main__":
    for name, fn in [("bearings-only", bearings_only), ("growth", growth_model)]:
        u, e, i = fn()
        print(f"{name}: mean RMS  UKF={u.mean():.4f}  EKF={e.mean():.4f}  "
              f"IEKF={i.mean():.4f}")
