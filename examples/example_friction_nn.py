"""Learning friction dynamics with a neural network inside an EKF.

JAX rendition of the reference's UDE-style friction tutorial
(/root/reference/docs/src/friction_nn_example.md): an actuated mass obeys
known physics (Newton's second law) but an UNKNOWN friction force with
Stribeck effect that additionally drifts over time.  A small MLP models
the friction as a function of velocity; its weights are appended to the
state vector and estimated online by an ExtendedKalmanFilter — the
filter is the training loop, and the nonzero weight process noise keeps
the weights plastic so recently-excited parts of the curve stay current.

Structure priors mirrored from the reference:
- anti-symmetry: the net sees |v| and its output is multiplied by
  sign(v) (friction_nn_example.md "friction_function"),
- weight dynamics: slow decay w⁺ = (1 - 1e-4·Ts)·w (the reference's
  continuous-time ``-0.0001 p``),
- measurement: physical states only, via an IndexingMatrix-backed
  LinearMeasurementModel (no dense [ny, nx+nw] matrix).

JAX-idiomatic differences: `jax.jacfwd` through the augmented dynamics
replaces the hand-wired sparse-Jacobian machinery; the whole filter pass
is ONE `lax.scan` under jit.

Run: ``python examples/example_friction_nn.py``
"""
import jax

try:
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import lowlevelparticlefilters_jl_tpu as llpf

TS = 0.1
MASS = 1.0
NX, NU, NY = 2, 1, 2
T_MAX = 400.0


def true_friction(v, t, f_s=2.0, f_c=1.0, v_s=0.1, f_v=0.5):
    """Stribeck friction, drifting +30% over the experiment
    (friction_nn_example.md:46-56)."""
    mult = 1.0 + 0.3 * (t * TS / T_MAX)
    mag = (f_c + (f_s - f_c) * jnp.exp(-jnp.abs(v) / v_s)) + f_v * jnp.abs(v)
    return jnp.where(jnp.abs(v) < 1e-6, 0.0, mag * jnp.sign(v) * mult)


def mass_dynamics(x, u, p, t):
    return jnp.array([x[1], (u[0] - true_friction(x[1], t)) / MASS])


true_step = llpf.rk4(mass_dynamics, TS, supersample=1)

# --- NN friction model: v -> friction magnitude ------------------------
HIDDEN = 6
N_W = (1 * HIDDEN + HIDDEN) + (HIDDEN * HIDDEN + HIDDEN) + (HIDDEN + 1) + 1


def nn_friction(w, v):
    """Anti-symmetric by construction: (net(|v|) + w_lin·|v|) * sign(v).

    The scaled input (|v|/3 — excitation reaches |v|≈7) keeps the tanh
    units out of saturation, and the learned linear bypass ``w_lin``
    carries the viscous slope so the tanh net only has to model the
    bounded Stribeck/Coulomb part."""
    i = 0
    W1 = w[i:i + HIDDEN].reshape(HIDDEN, 1); i += HIDDEN
    b1 = w[i:i + HIDDEN]; i += HIDDEN
    W2 = w[i:i + HIDDEN * HIDDEN].reshape(HIDDEN, HIDDEN); i += HIDDEN * HIDDEN
    b2 = w[i:i + HIDDEN]; i += HIDDEN
    W3 = w[i:i + HIDDEN].reshape(1, HIDDEN); i += HIDDEN
    b3 = w[i:i + 1]; i += 1
    w_lin = w[i]
    a = jnp.abs(v)
    h = jnp.tanh(W1 @ (a / 3.0)[None] + b1)
    h = jnp.tanh(W2 @ h + b2)
    return ((W3 @ h + b3)[0] + w_lin * a) * jnp.sign(v)


def hybrid_continuous(s, u, p, t):
    """Known physics + learned friction + weight decay."""
    x, w = s[:NX], s[NX:]
    acc = (u[0] - nn_friction(w, x[1])) / MASS
    return jnp.concatenate([jnp.array([x[1], acc]), -1e-4 * w])


hybrid_step = llpf.rk4(hybrid_continuous, TS, supersample=1)


def excitation(T):
    """Varied inputs exciting many velocities (friction_nn_example.md:84-100)."""
    t = jnp.arange(T) * TS
    q = T // 4
    u = jnp.where(
        jnp.arange(T) < q, 3.0 * jnp.cos(0.1 * t),
        jnp.where(
            jnp.arange(T) < 2 * q, 5.0 * jnp.sign(jnp.sin(0.5 * t)),
            jnp.where(
                jnp.arange(T) < 3 * q,
                2.0 * jax.random.normal(jax.random.PRNGKey(4), (T,)),
                4.0 * jnp.sin(2 * jnp.pi * (0.05 + 0.2 * (t - t[3 * q]) / (q * TS)) * t),
            ),
        ),
    )
    return u[:, None]


def main():
    T = 2 * int(200 / TS)
    us = jnp.concatenate([excitation(T // 2)] * 2, axis=0)

    def rollout(x0, us):
        """Filter-convention rollout: y[k] observes x[k], the transition
        x[k] -> x[k+1] uses u[k] (filtering.jl predict/correct order)."""
        def step(x, inp):
            u, t = inp
            return true_step(x, u, None, t), x
        _, xs = jax.lax.scan(step, x0, (us, jnp.arange(T)))
        return xs

    xs = rollout(jnp.zeros(NX), us)
    ys = xs + 0.01 * jax.random.normal(jax.random.PRNGKey(1), xs.shape)

    # --- EKF over the augmented state [x; w] ---------------------------
    w0 = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (N_W,))
    R1 = jnp.diag(jnp.concatenate([
        1e-3 * jnp.ones(NX),          # physical-state process noise
        1e-4 * jnp.ones(N_W),         # weight noise: the learning rate
    ]))
    R2 = 0.05**2 * jnp.eye(NY)
    mm = llpf.LinearMeasurementModel(
        C=llpf.indexing_matrix(jnp.arange(NX), NX + N_W), R2=R2, ny=NY)
    ekf = llpf.make_ekf(
        hybrid_step, mm, R1, None,
        d0=llpf.MvNormal(jnp.concatenate([jnp.zeros(NX), w0]), 1e4 * R1),
        nu=NU, ny=NY, Ts=TS)

    sol = llpf.forward_trajectory(ekf, us, ys)
    assert bool(sol.ok.all())
    w_mid = sol.xt[T // 2, NX:]
    w_end = sol.xt[-1, NX:]

    vgrid = jnp.linspace(-5.0, 5.0, 101)
    f_true_0 = jax.vmap(lambda v: true_friction(v, 0.0))(vgrid)
    f_true_end = jax.vmap(lambda v: true_friction(v, float(T)))(vgrid)
    f_nn_mid = jax.vmap(lambda v: nn_friction(w_mid, v))(vgrid)
    f_nn_end = jax.vmap(lambda v: nn_friction(w_end, v))(vgrid)

    # exclude the hard-to-identify Stribeck spike region near v=0
    mask = jnp.abs(vgrid) > 0.25
    rms0 = float(jnp.sqrt(jnp.mean(jnp.where(mask, (f_nn_end - f_true_0) ** 2, 0))))
    rmse = float(jnp.sqrt(jnp.mean(jnp.where(mask, (f_nn_end - f_true_end) ** 2, 0))))
    print(f"EKF ll = {float(sol.ll):.1f}")
    print(f"learned-friction RMSE: {rms0:.3f} vs t=0 curve, "
          f"{rmse:.3f} vs final drifted curve")
    # The filter learns the friction curve to ~10% of its 0-4.5 range
    # purely online.  (Full-curve drift tracking is NOT claimed: the
    # filter only updates the curve where the recent excitation visits,
    # so high-|v| regions retain the friction seen when last excited.)
    assert min(rms0, rmse) < 0.6, "friction fit degraded"
    return sol, (vgrid, f_nn_mid, f_nn_end, f_true_0, f_true_end)


if __name__ == "__main__":
    main()
