"""Beetle tracking with an IMM of augmented-dynamics UKFs + ML tuning.

JAX rendition of the reference's docs/src/beetle_example_imm.md:
the dung-beetle track's behavioral mode switch (goal-directed vs
searching) is modeled as a 2-mode Interacting-Multiple-Models filter
whose modes are two augmented-dynamics UKFs differing only in how much
noise enters the heading angle (``modegain``).  The searching mode is
"sticky" (terminal) via the transition matrix.

Where the reference tunes the noise covariances with a gradient-FREE
optimizer (ParticleSwarm — ForwardDiff through the Julia IMM is noted as
numerically difficult), here the whole IMM log-likelihood is a jittable
pure function, so we tune by exact `jax.grad` + Adam — the functional
rewrite makes the filter differentiable end-to-end.

State: [px, py, v, θ];  augmented noise w = [wx, wy, wv, wθ] (nw=4);
measurement: position.  Run: ``python examples/example_beetle_imm.py``
"""
import jax

try:
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import optax

import lowlevelparticlefilters_jl_tpu as llpf

NY = 2
DG_SIG = 0.1    # measurement noise std
DV_SIG = 0.05   # velocity noise std
PHI_SIG = 0.1   # heading noise std (goal-directed mode)
MODEGAIN = 8.0  # searching mode: heading noise scaled by (1 + modegain)
P_STICKY = jnp.array([[0.995, 0.005], [0.0, 1.0]])
MU0 = jnp.array([1.0, 0.0])


def make_dynamics(mode: float):
    """Augmented-dynamics UKF form f(x, u, p, t, w); ``p`` carries the
    modegain (beetle_example_imm.md's closed-over ``m`` flag)."""

    def dyn(x, u, p, t, w):
        modegain = p
        v_n = jnp.abs(0.999 * x[2] + w[2])
        th_n = x[3] + w[3] * (1 + mode * modegain) / (1 + v_n)
        px = x[0] + w[0] + v_n * jnp.cos(x[3])
        py = x[1] + w[1] + v_n * jnp.sin(x[3])
        return jnp.array([px, py, v_n, th_n])

    return dyn


def meas(x, u, p, t):
    return x[:2]


def build_imm(log10_r1_diag, log10_r2_scale, log10_modegain, d0):
    """Parameter vector -> IMM (the reference's ``get_opt_kf``)."""
    R1 = jnp.diag(10.0 ** log10_r1_diag)
    R2 = (10.0 ** log10_r2_scale) * DG_SIG**2 * jnp.eye(NY)
    modegain = 2.0 + 10.0 ** log10_modegain
    modes = tuple(
        llpf.make_ukf(
            make_dynamics(m), meas, R1, R2, d0=d0,
            nu=0, ny=NY, nw=4, augmented_dynamics=True, p=modegain,
        )
        for m in (0.0, 1.0)
    )
    return llpf.IMM(modes, P_STICKY, MU0)


def simulate_track(key, T=300, t_switch=150):
    """Synthesize a track from the generative model (the reference loads
    a lab dataset; this repo ships no data files)."""

    def step(carry, inp):
        x, k = carry
        t, = inp
        k, kw = jax.random.split(k)
        mode = (t >= t_switch).astype(jnp.float32)
        w = jax.random.normal(kw, (4,)) * jnp.array(
            [0.03, 0.03, DV_SIG, PHI_SIG])
        # searching mode: heading noise amplified, same as the filter model
        w = w.at[3].multiply(1 + mode * MODEGAIN)
        xn = make_dynamics(0.0)(x, None, 0.0, t, w)
        return (xn, k), xn

    x0 = jnp.array([0.0, 0.0, 0.5, 0.3])
    key, km = jax.random.split(key)
    (_, _), xs = jax.lax.scan(step, (x0, key), (jnp.arange(T),))
    ys = xs[:, :2] + DG_SIG * jax.random.normal(km, (T, NY))
    return xs, ys


def main():
    key = jax.random.PRNGKey(0)
    T, t_switch = 300, 150
    xs, ys = simulate_track(key, T, t_switch)
    us = jnp.zeros((T, 0))
    d0 = llpf.MvNormal(
        jnp.concatenate([ys[0], jnp.array([0.5, 0.3])]),
        jnp.diag(jnp.array([3.0, 3.0, 2.0, 2.0])),
    )

    # --- initial (hand-tuned) filter --------------------------------
    p0 = (jnp.log10(jnp.array([1e-2, 1e-2, DV_SIG**2, PHI_SIG**2])),
          jnp.asarray(0.0), jnp.asarray(jnp.log10(MODEGAIN - 2.0)))
    imm = build_imm(*p0, d0)
    sol = llpf.forward_trajectory(imm, us, ys)
    mu = sol.extra  # [T, 2] mode probabilities
    print(f"initial IMM ll = {float(sol.ll):.1f}")
    print(f"P(search) @ t={t_switch - 10}: {float(mu[t_switch - 10, 1]):.2f}, "
          f"@ t={t_switch + 25}: {float(mu[t_switch + 25, 1]):.2f}")

    # --- ML tuning by exact gradients -------------------------------
    def nll(params):
        return -build_imm(*params, d0).loglik(us, ys)

    # The reference's `cost` try/catches filter divergence and returns Inf
    # for the gradient-free optimizer; the functional analogue is to zero
    # NaN gradients and keep the best finite iterate.
    opt = optax.chain(optax.zero_nans(), optax.adam(0.05))
    params = best = p0
    best_v = float("inf")
    state = opt.init(params)
    vg = jax.jit(jax.value_and_grad(nll))
    for i in range(30):
        v, g = vg(params)
        if float(v) < best_v:
            best, best_v = params, float(v)
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)
        if i % 10 == 0:
            print(f"  iter {i:2d}: nll = {float(v):.1f}")
    sol_opt = llpf.forward_trajectory(build_imm(*best, d0), us, ys)
    print(f"tuned   IMM ll = {float(sol_opt.ll):.1f}")
    mu_o = sol_opt.extra
    print(f"P(search) @ t={t_switch - 10}: {float(mu_o[t_switch - 10, 1]):.2f}, "
          f"@ t={t_switch + 25}: {float(mu_o[t_switch + 25, 1]):.2f}")
    return sol, sol_opt, xs


if __name__ == "__main__":
    main()
