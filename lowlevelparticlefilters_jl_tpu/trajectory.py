"""Batch filtering along a trajectory — the sequential hot loop.

A JAX re-design of the reference's src/filtering.jl:282-327
(`forward_trajectory`): the per-step Python loop becomes one `lax.scan`
whose carry is the filter state and whose stacked outputs are the solution
fields.  The whole function is jit-able and `jax.grad`-able end to end
(the reference needs ForwardDiff through mutation; here reverse-mode AD
through the scan is free).

The four-callback protocol (pre/post correct/predict, filtering.jl:270-281)
is preserved as pure functions traced into the scan body:

- ``pre_correct_cb(f, state, u, y, p, t) -> R2-override or None``
- ``post_correct_cb(f, state, info, u, y, p, t) -> (state, extra) or None``
- ``pre_predict_cb(f, state, u, y, p, t, info) -> R1-override or None``
- ``post_predict_cb(f, state, u, y, p, t) -> state or None``
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from .utils.solutions import KalmanFilteringSolution, ParticleFilteringSolution
from .filters.base import AbstractKalmanFilter


def _as_u_seq(u, T, dtype):
    """Coerce the input sequence: None -> [T, 0] zeros; arrays -> asarray;
    any other pytree (dict/tuple of per-step stacked leaves) passes through
    untouched — `lax.scan` slices pytree xs natively, giving the
    reference's arbitrary-u support (test_ukf.jl custom-u)."""
    if u is None:
        return jnp.zeros((T, 0), dtype=dtype)
    if isinstance(u, (jnp.ndarray,)) or hasattr(u, "shape"):
        return jnp.asarray(u)
    import numpy as _np
    if isinstance(u, (list, _np.ndarray)):
        return jnp.asarray(u)
    return u


def _time_vector(f, T: int):
    Ts = getattr(f, "Ts", 1.0)
    return jnp.arange(T) * Ts


def forward_trajectory(
    f,
    u,
    y,
    p=None,
    *,
    pre_correct_cb: Optional[Callable] = None,
    post_correct_cb: Optional[Callable] = None,
    pre_predict_cb: Optional[Callable] = None,
    post_predict_cb: Optional[Callable] = None,
    method: str = "auto",
    **kwargs,
):
    """Run a filter over stacked inputs ``u[T, nu]`` / measurements ``y[T, ny]``.

    Dispatches on filter family: Kalman-type filters return a
    :class:`KalmanFilteringSolution`, particle filters a
    :class:`ParticleFilteringSolution` (via their own implementation).

    ``method="auto"`` and ``"sequential"`` run the `lax.scan` recursion;
    ``"parallel"`` routes plain-KF and affine UKF/EKF calls (without
    per-step callbacks) to the O(log T) temporal-parallel filter
    (routing.py).
    """
    if not hasattr(f, "forward_trajectory"):
        from .routing import route_forward_trajectory

        has_cb = any(cb is not None for cb in (
            pre_correct_cb, post_correct_cb, pre_predict_cb,
            post_predict_cb))
        routed = route_forward_trajectory(f, u, y, p, method, has_cb,
                                          kwargs)
        if routed is not None:
            return _stamp_route(routed, "forward_trajectory")
    if hasattr(f, "forward_trajectory"):
        return _stamp_route(f.forward_trajectory(
            u,
            y,
            p,
            pre_correct_cb=pre_correct_cb,
            post_correct_cb=post_correct_cb,
            pre_predict_cb=pre_predict_cb,
            post_predict_cb=post_predict_cb,
            **kwargs,
        ), None)
    return _stamp_route(kalman_forward_trajectory(
        f,
        u,
        y,
        p,
        pre_correct_cb=pre_correct_cb,
        post_correct_cb=post_correct_cb,
        pre_predict_cb=pre_predict_cb,
        post_predict_cb=post_predict_cb,
        **kwargs,
    ), None)


def _stamp_route(sol, verb):
    """Record execution-path provenance on a solution (static field; see
    utils/solutions.py).  ``verb=None`` means the sequential/in-filter
    scan ran (no routing record to consult)."""
    if not hasattr(sol, "route"):
        return sol
    if verb is None:
        path = "xla_scan"
    else:
        from .routing import last_route

        path = last_route(verb)
    try:
        return sol.replace(route=path)
    except Exception:  # pragma: no cover - exotic solution containers
        return sol


def kalman_forward_trajectory(
    kf,
    u,
    y,
    p=None,
    *,
    pre_correct_cb=None,
    post_correct_cb=None,
    pre_predict_cb=None,
    post_predict_cb=None,
    mm=None,
    unroll: int = 1,
):
    """`forward_trajectory` for Kalman-type filters (filtering.jl:282-327).

    Step order matches the reference exactly: save prediction → correct →
    save filtered → predict.  ``unroll`` unrolls the scan body (a
    small-state sequential pass is bound by per-step overhead; unrolling
    amortizes the loop bookkeeping at the cost of compile time).
    """
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype)
    tvec = _time_vector(kf, T)
    state0 = kf.init()

    def step(state, inp):
        uk, yk, tk = inp
        x_pred, R_pred = kf.state(state), kf.covariance(state)
        R2 = pre_correct_cb(kf, state, uk, yk, p, tk) if pre_correct_cb else None
        state, info = kf.correct(state, uk, yk, p, tk, R2=R2, mm=mm)
        extra = None
        if post_correct_cb:
            out = post_correct_cb(kf, state, info, uk, yk, p, tk)
            if out is not None:
                state, extra = out
        x_filt, R_filt = kf.state(state), kf.covariance(state)
        R1 = pre_predict_cb(kf, state, uk, yk, p, tk, info) if pre_predict_cb else None
        state = kf.predict(state, uk, p, tk, R1=R1)
        if post_predict_cb:
            out = post_predict_cb(kf, state, uk, yk, p, tk)
            if out is not None:
                state = out
        ok = jnp.all(jnp.isfinite(x_filt)) & jnp.all(jnp.isfinite(info.e))
        ys = (x_pred, R_pred, x_filt, R_filt, info.ll, info.e, info.S, info.Schol, info.K, extra, ok)
        return state, ys

    _, (x, R, xt, Rt, lls, e, S, Schol, K, extra, ok) = jax.lax.scan(
        step, state0, (u_seq, y, tvec), unroll=unroll
    )
    return KalmanFilteringSolution(
        u=u_seq,
        y=y,
        x=x,
        xt=xt,
        R=R,
        Rt=Rt,
        ll=jnp.sum(lls),
        e=e,
        K=K,
        S=S,
        extra=extra,
        t=tvec,
        ok=ok,
    )


# ---------------------------------------------------------------------------
# Low-memory objectives (reference src/smoothing.jl:153-258) — same compute
# as forward_trajectory, nothing stored but the running reduction.
# ---------------------------------------------------------------------------


def loglik(f, u, y, p=None, unroll: int = 1, method: str = "auto", **kwargs):
    """Total log-likelihood of the data (smoothing.jl:227-236).

    ``method="auto"`` and ``"sequential"`` run the `lax.scan`
    recursion; ``"parallel"`` routes plain-KF and affine UKF/EKF calls to
    the O(log T) temporal-parallel filter (routing.py).  Every route
    differentiates.
    """
    if hasattr(f, "loglik"):
        from .filters.particle import _ParticleCommon

        if isinstance(f, _ParticleCommon):
            return f.loglik(u, y, p, method=method, **kwargs)
        from .routing import _record

        _record("loglik", "xla_scan")
        return f.loglik(u, y, p, **kwargs)
    from .routing import route_kalman_loglik

    routed = route_kalman_loglik(f, u, y, p, method, kwargs)
    if routed is not None:
        return routed
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype)
    tvec = _time_vector(f, T)
    state0 = f.init()

    def step(state, inp):
        uk, yk, tk = inp
        state, info = f.update(state, uk, yk, p, tk, **kwargs)
        return state, info.ll

    _, lls = jax.lax.scan(step, state0, (u_seq, y, tvec), unroll=unroll)
    return jnp.sum(lls)


def sse(f, u, y, p=None, lam=1.0):
    """Sum of squared prediction errors ``Σ eᵀ λ e`` (smoothing.jl:153-160)."""
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype)
    tvec = _time_vector(f, T)
    state0 = f.init()
    lam = jnp.asarray(lam)

    def step(state, inp):
        uk, yk, tk = inp
        state, info = f.update(state, uk, yk, p, tk)
        e = info.e
        w = lam * e if lam.ndim < 2 else lam @ e
        return state, jnp.dot(e, w)

    _, sses = jax.lax.scan(step, state0, (u_seq, y, tvec))
    return jnp.sum(sses)


def loglik_x(f, u, y, x, p=None):
    """State-sequence log-likelihood for Kalman-type filters
    (smoothing.jl:243-258): ``Σ logpdf(N(0, R(t|t-1)), x_t - x̂_t)`` using
    prediction errors, summed over t = 1..T-1 like the reference."""
    from .ops.mvnormal import mvnormal_logpdf_cov

    y = jnp.asarray(y)
    x = jnp.asarray(x)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype)
    tvec = _time_vector(f, T)
    state0 = f.init()

    def step(state, inp):
        uk, yk, xk, tk = inp
        xe = xk - f.state(state)
        state, _ = f.correct(state, uk, yk, p, tk)
        state = f.predict(state, uk, p, tk)
        ll = mvnormal_logpdf_cov(xe, jnp.zeros_like(xe), f.covariance(state))
        return state, ll

    _, lls = jax.lax.scan(step, state0, (u_seq, y, x, tvec))
    return jnp.sum(lls[:-1])


# ---------------------------------------------------------------------------
# Simulation (filtering.jl:443-477) and rollout (filtering.jl:527-533)
# ---------------------------------------------------------------------------


def simulate(
    f,
    u_or_T,
    key: jax.Array,
    p=None,
    *,
    du=None,
    dynamics_noise: bool = True,
    measurement_noise: bool = True,
    sample_initial: bool = False,
):
    """Draw one trajectory from the filter's generative model.

    ``x, u, y = simulate(f, u, key)`` with ``u`` of shape [T, nu], or
    ``simulate(f, T, key, du=input_density)`` to sample random inputs —
    mirrors filtering.jl:457-477.  Returns stacked arrays
    (x: [T, nx], u: [T, nu], y: [T, ny]).

    Filters whose measurement model carries an R12 cross-covariance
    dispatch to their joint-noise simulator (ekf.jl:233-272) so the
    generated data carries the modeled correlation.
    """
    if isinstance(u_or_T, int):
        # Sample the input sequence first so the R12 joint-noise dispatch
        # below also covers simulate(f, T, key, du=...).
        if du is None:
            raise ValueError("provide du (input density) when simulating T steps")
        key, ku = jax.random.split(key)
        u_or_T = du.sample(ku, (u_or_T,))
    if (
        hasattr(f, "simulate_correlated")
        and getattr(getattr(f, "measurement_model", None), "R12", None) is not None
        and dynamics_noise and measurement_noise
    ):
        return f.simulate_correlated(
            u_or_T, key, p, dynamics_noise=dynamics_noise,
            measurement_noise=measurement_noise, sample_initial=sample_initial,
        )
    p = getattr(f, "p", None) if p is None else p
    u = jnp.asarray(u_or_T)
    T = u.shape[0]
    Ts = getattr(f, "Ts", 1.0)

    key, k0 = jax.random.split(key)
    x1 = f.sample_initial(k0, p, noise=sample_initial)
    # typed keys (jax.random.key) split to shape [2T]; raw uint32 keys
    # (jax.random.PRNGKey) to [2T, 2] — reshape the leading axis only
    keys = jax.random.split(key, 2 * T)
    keys = keys.reshape(T, 2, *keys.shape[1:])

    def step(x, inp):
        uk, tk, kk = inp
        y = f.sample_measurement(kk[0], x, uk, p, tk, noise=measurement_noise)
        xn = f.sample_state(kk[1], x, uk, p, tk, noise=dynamics_noise)
        return xn, (x, y)

    tvec = jnp.arange(T) * Ts
    _, (x, y) = jax.lax.scan(step, x1, (u, tvec, keys))
    return x, u, y


def rollout(dyn: Callable, x0, u, p=None, Ts: float = 1.0):
    """Open-loop rollout of a dynamics function (filtering.jl:527-533).

    Returns [T+1, nx] — x0 followed by the propagated states.
    """
    u = jnp.asarray(u)

    def step(x, inp):
        uk, tk = inp
        xn = dyn(x, uk, p, tk)
        return xn, xn

    tvec = (jnp.arange(u.shape[0]) + 1) * Ts
    _, xs = jax.lax.scan(step, jnp.asarray(x0), (u, tvec))
    return jnp.concatenate([jnp.asarray(x0)[None], xs], axis=0)


# ---------------------------------------------------------------------------
# Weighted statistics (filtering.jl:541-595)
# ---------------------------------------------------------------------------


def weighted_mean(x: jax.Array, we: jax.Array) -> jax.Array:
    """Weighted mean over the particle axis.

    ``x`` is [..., N, nx], ``we`` is [..., N]; returns [..., nx].
    """
    return jnp.einsum("...n,...nd->...d", we, x)


def weighted_cov(x: jax.Array, we: jax.Array) -> jax.Array:
    """Weighted (frequency-corrected) covariance per time step
    (filtering.jl:575-579). ``x``: [..., N, nx], ``we``: [..., N]."""
    m = weighted_mean(x, we)
    d = x - m[..., None, :]
    cov = jnp.einsum("...n,...ni,...nj->...ij", we, d, d)
    # ProbabilityWeights correction: 1 / (1 - sum(we^2))
    corr = 1.0 / (1.0 - jnp.sum(jnp.square(we), axis=-1))
    return cov * corr[..., None, None]


def weighted_quantile(x: jax.Array, we: jax.Array, q) -> jax.Array:
    """Weighted quantile per dimension (filtering.jl:592-595).

    ``x``: [..., N, nx], ``we``: [..., N].  Uses the weighted-CDF inversion
    definition (matches StatsBase for interior quantiles up to tie-breaking).
    """
    order = jnp.argsort(x, axis=-2)
    xs = jnp.take_along_axis(x, order, axis=-2)
    ws = jnp.take_along_axis(we[..., None] * jnp.ones_like(x), order, axis=-2)
    cdf = jnp.cumsum(ws, axis=-2)
    cdf = cdf / cdf[..., -1:, :]
    q = jnp.asarray(q)
    idx = jnp.sum(cdf < q, axis=-2)
    idx = jnp.clip(idx, 0, x.shape[-2] - 1)
    return jnp.take_along_axis(xs, idx[..., None, :], axis=-2)[..., 0, :]


def mean_trajectory(x, we=None, y=None, *, p=None, key=None,
                    method: str = "auto") -> jax.Array:
    """Weighted mean along a particle trajectory (filtering.jl:393-440).

    Two forms, like the reference:

    - array form ``mean_trajectory(x [T, N, nx], we [T, N])`` — reduce a
      stored particle solution;
    - filter form ``mean_trajectory(pf, u, y, key=...)`` — run the filter
      (``forward_trajectory``) and return the [T, nx] filtered means.
    """
    if hasattr(x, "forward_trajectory"):
        f, u = x, we
        from .routing import _check_method, _record

        _check_method(method)
        _record("mean_trajectory", "xla_scan")
        sol = f.forward_trajectory(u, y, p, key=key)
        return weighted_mean(sol.x, sol.we)
    return weighted_mean(x, we)


def mode_trajectory(x: jax.Array, we: jax.Array) -> jax.Array:
    """Highest-weight particle per step ([T, N, nx] → [T, nx])."""
    idx = jnp.argmax(we, axis=-1)
    return jnp.take_along_axis(x, idx[..., None, None], axis=-2)[..., 0, :]


def simulate_ensemble(f, u, key: jax.Array, n_runs: int, p=None, **kwargs):
    """N-run Monte-Carlo simulation — the MonteCarloMeasurements-extension
    analogue (/root/reference/ext/LowLevelParticleFiltersMonteCarloMeasurementsExt.jl:10-31):
    instead of `Particles` uncertainty types, returns stacked arrays
    ``(x [n_runs, T, nx], u, y [n_runs, T, ny])`` — the natural JAX
    representation of a trajectory ensemble (reduce with mean/std/
    quantiles along axis 0).

    The returned ``u`` matches how inputs were generated: with an explicit
    ``u`` array every run shares it, so the [T, nu] array is returned
    as-is; with the integer-T + ``du`` form each run samples its OWN input
    sequence (as the reference ext does — u becomes a Particles ensemble
    there too), so the full stacked [n_runs, T, nu] array is returned and
    ``u[i]`` pairs with ``x[i]``/``y[i]``.
    """
    keys = jax.random.split(key, n_runs)
    xs, us, ys = jax.vmap(lambda k: simulate(f, u, k, p, **kwargs))(keys)
    if isinstance(u, int):
        return xs, us, ys
    return xs, us[0], ys
