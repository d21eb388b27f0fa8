"""Learning a solar-insolation disturbance model with a UKF + RBF basis.

JAX rendition of the reference's thermal/SciML tutorial
(/root/reference/docs/src/thermal_nn_example.md): the temperature of a
house is driven by a heater (known), heat loss to a known external
temperature, and sun shining in through windows — an UNKNOWN, partly
stochastic disturbance.  The clear-sky insolation profile is modeled as
a radial-basis-function expansion over time-of-day whose weights are
learned from data; the stochastic cloud cover is carried as an extra
state estimated online by the filter ("disturbance modeling by state
augmentation").

The reference optimizes the RBF weights with Optim.BFGS + ForwardDiff
over `sse(kf, u, y, θ)`; here the same `sse` is a jittable function of
θ, minimized with exact reverse-mode gradients (Adam).  The parameter
vector flows through the standard SciML-style ``p`` argument — no filter
reconstruction needed per iteration.

Run: ``python examples/example_thermal_nn.py``
"""
import jax

try:
    jax.devices()
except RuntimeError:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import optax

import lowlevelparticlefilters_jl_tpu as llpf

C_TH = 10.0      # thermal capacity (kWh/degC)
K_LOSS = 0.5     # heat-loss coefficient (kW/degC)
ETA = 0.95       # heater efficiency
A_WIN = 20.0     # effective window area factor
TS = 0.25        # 15-minute sampling
HOURS = 24.0
N_BASIS = 8
NX, NU, NY = 2, 1, 1   # [T_room, cloud]; heater; temperature-only measurement


def time_of_day(t):
    return jnp.mod(t, HOURS)


def external_temp(t):
    return 10.0 + 5.0 * jnp.sin(2 * jnp.pi * (time_of_day(t) - 6) / HOURS)


def true_insolation(t, cloud):
    base = jnp.maximum(500.0 * (0.2 + jnp.sin(jnp.pi * (time_of_day(t) - 6) / 12)), 0.0)
    return base * (1 - cloud)


def basis_functions(t):
    centers = jnp.linspace(7.0, 17.0, N_BASIS)
    return jnp.exp(-(((time_of_day(t) - centers) / 1.5) ** 2))


def rbf_insolation(t, weights):
    return weights @ basis_functions(t)


def thermal_true(x, u, p, t):
    T_room, cloud = x
    dT = (-K_LOSS * (T_room - external_temp(t)) + ETA * u[0]
          + A_WIN * true_insolation(t, cloud) / 1000) / C_TH
    return jnp.array([dT, 0.0])


true_step = llpf.rk4(thermal_true, TS)


def hybrid_dynamics(x, u, p, t):
    """Known physics + RBF insolation (weights = p) + cloud random walk."""
    T_room, cloud = x
    I_solar = rbf_insolation(t, p) * (1 - cloud)
    dT = (-K_LOSS * (T_room - external_temp(t)) + ETA * u[0]
          + A_WIN * I_solar / 1000) / C_TH
    dc = 1e-4 * (0.5 - cloud)
    return jnp.array([dT, dc])


def clamped_step(x, u, p, t):
    # forward-Euler + cloud clamp (thermal_nn_example.md "clamped_dynamics")
    xp = x + TS * hybrid_dynamics(x, u, p, t)
    return jnp.array([xp[0], jnp.clip(xp[1], 0.0, 1.0)])


def heater_schedule(key, T):
    t = jnp.arange(T) * TS
    tod = time_of_day(t)
    base = jnp.where((tod >= 6) & (tod < 8) | (tod >= 17) & (tod < 22), 3.0,
                     jnp.where((tod >= 22) | (tod < 6), 1.0, 2.0))
    u = base + 0.3 * jax.random.normal(key, (T,))
    return jnp.clip(u, 0.0, 5.0)[:, None]


def generate_data(days=10, key=jax.random.PRNGKey(123)):
    T = int(days * HOURS / TS)
    ku, kw, km = jax.random.split(key, 3)
    us = heater_schedule(ku, T)
    ws = jax.random.normal(kw, (T, 2)) * jnp.array([0.01, 0.06])

    def step(x, inp):
        u, w, t = inp
        xn = true_step(x, u, None, t * TS) + w
        xn = jnp.array([xn[0], jnp.clip(xn[1] * 0.999, 0.0, 1.0)])
        return xn, x

    _, xs = jax.lax.scan(step, jnp.array([20.0, 0.3]), (us, ws, jnp.arange(T)))
    ys = xs[:, :1] + 0.1 * jax.random.normal(km, (T, 1))
    return xs, us, ys


def make_filter():
    R1 = jnp.diag(jnp.array([0.01, 0.06]))
    mm = llpf.LinearMeasurementModel(
        C=llpf.indexing_matrix(jnp.array([0]), NX),
        R2=jnp.array([[0.1**2]]), ny=NY)
    return llpf.make_ukf(
        clamped_step, mm, R1, None,
        d0=llpf.MvNormal(jnp.array([20.0, 0.5]), 2 * R1),
        nu=NU, ny=NY, Ts=TS)


def main():
    xs, us, ys = generate_data()
    ukf = make_filter()

    def cost(theta):
        return llpf.sse(ukf, us, ys, p=theta)

    theta = 100.0 * jax.random.uniform(jax.random.PRNGKey(456), (N_BASIS,))
    vg = jax.jit(jax.value_and_grad(cost))
    opt = optax.adam(5.0)
    state = opt.init(theta)
    c0 = float(cost(theta))
    for i in range(150):
        v, g = vg(theta)
        upd, state = opt.update(g, state)
        theta = optax.apply_updates(theta, upd)
        if i % 50 == 0:
            print(f"  iter {i:3d}: sse = {float(v):.2f}")
    c1 = float(cost(theta))
    print(f"SSE {c0:.1f} -> {c1:.1f}")

    # learned clear-sky profile vs truth over one day
    tgrid = jnp.linspace(0.0, 24.0, 97)
    I_learned = jax.vmap(lambda t: rbf_insolation(t, theta))(tgrid)
    I_true = jax.vmap(lambda t: true_insolation(t, 0.0))(tgrid)
    day_mask = (tgrid >= 8) & (tgrid <= 16)
    rel = float(jnp.sqrt(jnp.mean(jnp.where(day_mask, (I_learned - I_true) ** 2, 0)))
                / jnp.sqrt(jnp.mean(jnp.where(day_mask, I_true**2, 1e-12))))
    print(f"daytime insolation profile relative RMSE: {rel:.3f}")

    sol = llpf.forward_trajectory(ukf, us, ys, p=theta)
    cloud_rmse = float(jnp.sqrt(jnp.mean((sol.xt[:, 1] - xs[:, 1]) ** 2)))
    print(f"cloud-cover tracking RMSE (unmeasured state): {cloud_rmse:.3f}")
    return theta, rel, cloud_rmse, sol


if __name__ == "__main__":
    main()
