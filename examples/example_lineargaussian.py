"""Linear-Gaussian benchmark: KF vs PF vs smoothers, loglik landscapes.

JAX rendition of the reference's examples/example_lineargaussian.jl
(the system behind docs/src/benchmark.md): a 2-state rotation-like system
where the KalmanFilter is exact, so every other estimator can be checked
against it, and the log-likelihood as a function of the noise scales peaks
at the true parameters (runtests.jl:412-450 pattern).

Run: ``python examples/example_lineargaussian.py``
"""
import jax

try:
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import lowlevelparticlefilters_jl_tpu as llpf

A = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]])
B = jnp.array([[0.1], [0.0]])
C = jnp.eye(2)
R1 = 0.01 * jnp.eye(2)
R2 = 0.1 * jnp.eye(2)


def main():
    kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
    key = jax.random.PRNGKey(0)
    us = 0.5 * jnp.sin(0.3 * jnp.arange(200))[:, None]
    xs, us, ys = llpf.simulate(kf, us, key)

    sol = llpf.forward_trajectory(kf, us, ys)
    ssol = llpf.smooth(kf, us, ys)
    mbf_ssol, *_ = llpf.smooth_mbf(sol, kf)

    pf = llpf.ParticleFilter(
        N=10_000,
        dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: C @ x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1,
    )
    sol_pf = llpf.forward_trajectory(pf, us, ys, key=jax.random.PRNGKey(1))
    apf = llpf.AuxiliaryParticleFilter(pf=pf)
    sol_apf = llpf.forward_trajectory(apf, us, ys, key=jax.random.PRNGKey(2))

    print(f"KF   ll = {float(sol.ll):9.2f}")
    print(f"PF   ll = {float(sol_pf.ll):9.2f}   (N=10k, should ≈ KF)")
    print(f"APF  ll = {float(sol_apf.ll):9.2f}")
    rmse = lambda x_: float(jnp.sqrt(jnp.mean((x_ - xs) ** 2)))
    print(f"filtered rmse {rmse(sol.xt):.4f}  RTS {rmse(ssol.xT):.4f}  "
          f"MBF {rmse(mbf_ssol.xT):.4f}")

    # loglik-vs-noise-scale curve peaks at the true value (scale = 1)
    scales = jnp.array([0.25, 0.5, 1.0, 2.0, 4.0])
    lls = jnp.stack([
        llpf.loglik(kf.replace(R2=s * R2), us, ys) for s in scales
    ])
    best = scales[jnp.argmax(lls)]
    print("loglik(scale):", {float(s): round(float(l), 1) for s, l in zip(scales, lls)})
    print(f"argmax at scale {float(best)} (true: 1.0)")
    return sol, ssol, sol_pf


if __name__ == "__main__":
    main()
