"""Temporal parallelism on one long trajectory.

The reference's filtering/smoothing loops are sequential O(T)
(/root/reference/src/filtering.jl:293-315, src/smoothing.jl:8-45) — the
right design for one CPU core.  On an accelerator the same single-stream
workload runs in O(log T) depth: `parallel_forward_trajectory` /
`parallel_rts_smooth` for linear-Gaussian models, and
`parallel_ukf_smooth` (iterated posterior-linearization with unscented
SLR) for nonlinear ones.  This example runs both on a constant-velocity
target-tracking model and checks them against the sequential filters.
"""
import jax
import jax.numpy as jnp

import lowlevelparticlefilters_jl_tpu as llpf


def main(T: int = 2_000):
    dt = 0.1
    A = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt],
                   [0, 0, 1, 0], [0, 0, 0, 1]], jnp.float32)
    C = jnp.array([[1, 0, 0, 0], [0, 1, 0, 0]], jnp.float32)
    R1 = 0.02 * jnp.eye(4, dtype=jnp.float32)
    R2 = 0.5 * jnp.eye(2, dtype=jnp.float32)
    kf = llpf.KalmanFilter(A, 0 * A[:, :1], C, 0, R1, R2)

    us = jnp.zeros((T, 1), jnp.float32)
    _, _, ys = llpf.simulate(kf, us, jax.random.PRNGKey(0))

    # --- linear: O(log T) filter + RTS smoother -------------------------
    psol = llpf.parallel_forward_trajectory(kf, us, ys)
    pss = llpf.parallel_rts_smooth(kf, us, ys)
    ssol = llpf.forward_trajectory(kf, us, ys)

    # --- nonlinear: iterated sigma-point smoother on a 1-D drag model ---
    # (2-state so the CPU test compile stays fast; the plane pipeline's
    # unrolled combine graph grows ~nx³ and nx=4 compiles for minutes on
    # the XLA CPU backend)
    def dyn(x, u, p, t):
        v = x[1]
        drag = 0.05 * jnp.sqrt(jnp.abs(v) + 1e-3) * v
        return jnp.array([x[0] + dt * v, v - dt * drag])

    ukf = llpf.make_ukf(dyn, lambda x, u, p, t: x[:1],
                        0.02 * jnp.eye(2, dtype=jnp.float32),
                        0.5 * jnp.eye(1, dtype=jnp.float32),
                        ny=1, nu=1)
    _, _, ys_nl = llpf.simulate(ukf, us, jax.random.PRNGKey(1))
    pnl = llpf.parallel_ukf_smooth(ukf, us, ys_nl, iters=3)
    snl = ukf.smooth(us, ys_nl)
    return psol, ssol, pss, pnl, snl


if __name__ == "__main__":
    psol, ssol, pss, pnl, snl = main()
    print("parallel ll", float(psol.ll), "sequential ll", float(ssol.ll))
    rmse = float(jnp.sqrt(jnp.mean((pnl.xT - snl.xT) ** 2)))
    print("nonlinear parallel vs sequential smoother RMSE", rmse)
