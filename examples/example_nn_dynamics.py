"""Adaptive neural-network dynamics learning with a state estimator.

JAX rendition of the reference's adaptive-NN workflow
(/root/reference/docs/src/neural_network.md): treat the weights of a
black-box neural-network dynamics model as *state variables* and let a
nonlinear Kalman filter estimate them online, jointly with the physical
state.  The filter IS the training algorithm — every measurement update
is one implicit Gauss-Newton step on the weights, and the weight
covariance quantifies how much the network has learned.

Differences from the reference are deliberate and JAX-idiomatic:
- the network Jacobian comes from `jax.jacfwd` through the augmented
  dynamics (the reference wires up DifferentiationInterface + sparsity
  detection by hand),
- the whole filter pass is ONE `lax.scan` under jit,
- a second phase shows *offline* refinement: gradient descent on the
  filter log-likelihood w.r.t. the initial weights, i.e. backprop through
  the entire estimator.

Run: ``python examples/example_nn_dynamics.py``
"""
import jax

try:  # fall back to CPU when no accelerator backend is usable
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import lowlevelparticlefilters_jl_tpu as llpf

# --- true system: quadtank (same plant as example_quadtank.py) -------------
K1, K2, G = 1.6, 1.6, 9.81
AREA = 4.9
OUTLET = 0.03
GAMMA1, GAMMA2 = 0.3, 0.3
TS = 2.0
NX, NU, NY = 4, 2, 4  # full state measured, as in the reference NN tutorial


def ssqrt(x):
    return jnp.sqrt(jnp.maximum(x, 1e-6))


def quadtank(h, u, p, t):
    a, A = OUTLET, AREA
    q = ssqrt(2 * G * h)
    return jnp.array([
        -a / A * q[0] + a / A * q[2] + GAMMA1 * K1 / A * u[0],
        -a / A * q[1] + a / A * q[3] + GAMMA2 * K2 / A * u[1],
        -a / A * q[2] + (1 - GAMMA2) * K2 / A * u[1],
        -a / A * q[3] + (1 - GAMMA1) * K1 / A * u[0],
    ])


true_dynamics = llpf.rk4(quadtank, TS, supersample=2)

# --- black-box model: tiny MLP, weights packed in one flat vector ----------
HIDDEN = 6
N_W1 = (NX + NU) * HIDDEN + HIDDEN      # first layer + bias
N_W = N_W1 + HIDDEN * NX + NX           # + output layer + bias


def mlp_delta(w, x, u):
    """One-step state increment predicted by the network: x+ = x + net."""
    z = jnp.concatenate([x * 0.1, u])            # crude input scaling
    W1 = w[: (NX + NU) * HIDDEN].reshape(HIDDEN, NX + NU)
    b1 = w[(NX + NU) * HIDDEN : N_W1]
    W2 = w[N_W1 : N_W1 + HIDDEN * NX].reshape(NX, HIDDEN)
    b2 = w[N_W1 + HIDDEN * NX :]
    return W2 @ jnp.tanh(W1 @ z + b1) + b2


def augmented_dynamics(xa, u, p, t):
    """[x; w]⁺ — the state carries the network weights (random-walk)."""
    x, w = xa[:NX], xa[NX:]
    return jnp.concatenate([x + mlp_delta(w, x, u), w])


def measurement(xa, u, p, t):
    return xa[:NX]


def measurement_jac(xa, u, p, t):
    """Constant sparse Jacobian [I 0] — the reference hand-codes the same
    (neural_network.md: `CJ_ = [I(nx) zeros(...)]`)."""
    return jnp.concatenate([jnp.eye(NX), jnp.zeros((NX, N_W))], axis=1)


def build_filter(sigma_w: float):
    """EKF over the augmented state; sigma_w sets the weight drift rate."""
    R1 = jnp.diag(jnp.concatenate([
        1e-2 * jnp.ones(NX),                     # physical-state noise
        sigma_w**2 * jnp.ones(N_W),              # weight random walk
    ]))
    R2 = 0.05**2 * jnp.eye(NY)
    d0 = llpf.MvNormal(
        jnp.concatenate([jnp.full(NX, 5.0), jnp.zeros(N_W)]),
        jnp.diag(jnp.concatenate([jnp.ones(NX), 0.1 * jnp.ones(N_W)])),
    )
    return llpf.make_ekf(augmented_dynamics, measurement, R1, R2, d0=d0,
                         nu=NU, ny=NY, Ts=TS, Cjac=measurement_jac)


def simulate_data(T: int, key):
    """Excite the true plant with a slow random-step input sequence."""
    ku, kw, kv = jax.random.split(key, 3)
    steps = jax.random.uniform(ku, (T // 25 + 1, NU), minval=0.2, maxval=1.2)
    u = jnp.repeat(steps, 25, axis=0)[:T]

    def step(x, inp):
        uk, kk = inp
        xn = true_dynamics(x, uk, None, 0.0)
        xn = xn + 0.02 * jax.random.normal(jax.random.fold_in(kw, kk), (NX,))
        return xn, xn

    x0 = jnp.full(NX, 5.0)
    _, xs = jax.lax.scan(step, x0, (u, jnp.arange(T)))
    ys = xs + 0.05 * jax.random.normal(kv, (T, NY))
    return u, xs, ys


def one_step_rmse(w, u, xs):
    """One-step-ahead prediction RMSE of the network on held-out data."""
    pred = jax.vmap(lambda x, uu: x + mlp_delta(w, x, uu))(xs[:-1], u[:-1])
    return jnp.sqrt(jnp.mean((pred - xs[1:]) ** 2))


def main():
    key = jax.random.PRNGKey(0)
    u, xs, ys = simulate_data(1000, key)
    ekf = build_filter(sigma_w=1e-3)

    # --- phase 1: online learning — the filter trains the network --------
    sol = llpf.forward_trajectory(ekf, u, ys)
    w_early = sol.xt[15, NX:]        # mid-transient: barely trained
    w_conv = sol.xt[100, NX:]        # converged
    w_final = sol.xt[-1, NX:]

    uh, xh, _ = simulate_data(400, jax.random.PRNGKey(1))   # held-out
    rmse_early = float(one_step_rmse(w_early, uh, xh))
    rmse_conv = float(one_step_rmse(w_conv, uh, xh))
    rmse_final = float(one_step_rmse(w_final, uh, xh))
    print(f"held-out one-step RMSE  @t=15: {rmse_early:.4f}   "
          f"@t=100: {rmse_conv:.4f}   @t=end: {rmse_final:.4f}")

    # weight uncertainty contracted as the filter learned
    w_var0 = float(jnp.trace(sol.Rt[10, NX:, NX:]))
    w_varT = float(jnp.trace(sol.Rt[-1, NX:, NX:]))
    print(f"weight-covariance trace: {w_var0:.2f} -> {w_varT:.2f}")

    # --- phase 2: offline refinement — backprop THROUGH the filter -------
    def nll(w0):
        d0 = llpf.MvNormal(
            jnp.concatenate([jnp.full(NX, 5.0), w0]),
            jnp.diag(jnp.concatenate([jnp.ones(NX), 1e-3 * jnp.ones(N_W)])),
        )
        return -llpf.loglik(ekf.replace(d0=d0), u, ys)

    w0 = w_final
    grad = jax.jit(jax.grad(nll))
    for i in range(20):
        w0 = w0 - 1e-4 * grad(w0)
    rmse_refined = float(one_step_rmse(w0, uh, xh))
    print(f"held-out one-step RMSE after offline refinement: {rmse_refined:.4f}")
    return rmse_early, rmse_final, rmse_refined


if __name__ == "__main__":
    main()
