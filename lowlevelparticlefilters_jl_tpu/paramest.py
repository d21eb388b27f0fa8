"""Parameter estimation: PEM residuals, ML/MAP covariance tuning, PMMH.

A JAX re-design of the reference's estimation stack:
- `prediction_errors` (src/smoothing.jl:176-217) — whitened residuals
  incl. the log-determinant residual, as one differentiable `lax.scan`,
- `log_likelihood_fun` / `metropolis` / `metropolis_threaded`
  (src/smoothing.jl:266-347) — PMMH with the chain loop as `lax.scan` and
  the "threaded" variant as `vmap` over chains (one chain per device is a
  `shard_map` away; chains are embarrassingly parallel),
- `triangular`/`invtriangular`/`reconstruct_filter`
  (src/paramest.jl:24-99),
- `autotune_covariances` (ext/LowLevelParticleFiltersLSOptExt.jl:44-257)
  — MLE/MAP noise-covariance tuning.  The reference runs
  LevenbergMarquardt+ForwardDiff; here the same whitened-residual
  objective is minimized with a native Gauss-Newton/LM loop whose
  Jacobians come from `jax.jacfwd` *through the filter scan*.

Where the reference try/catches filter divergence and returns -Inf
(smoothing.jl:275-280), the jit-compatible equivalent maps non-finite
log-likelihoods to -Inf so PMMH rejects the proposal.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .ops.mvnormal import MvNormal, as_mvnormal
from .trajectory import loglik, _as_u_seq

_LOG2PI = 1.8378770664093453


# ---------------------------------------------------------------------------
# Triangular covariance parametrization (paramest.jl:24-48)
# ---------------------------------------------------------------------------


def triangular(x: jax.Array) -> jax.Array:
    """Vector of n(n+1)/2 parameters → upper-triangular matrix."""
    x = jnp.asarray(x)
    m = x.shape[-1]
    n = round((-1 + np.sqrt(1 + 8 * m)) / 2)
    iu = jnp.triu_indices(n)
    return jnp.zeros((n, n), x.dtype).at[iu].set(x)


def invtriangular(T: jax.Array) -> jax.Array:
    """Upper-triangular matrix → parameter vector (inverse of
    :func:`triangular`)."""
    T = jnp.asarray(T)
    return T[jnp.triu_indices(T.shape[-1])]


def reconstruct_filter(f, R1, R2, x0=None):
    """New filter of the same kind with replaced covariances / initial
    mean (paramest.jl:57-99).  Filters are immutable pytrees here, so this
    is a structural `replace` — no per-type constructors needed."""
    import dataclasses

    d0 = f.d0 if x0 is None else MvNormal(jnp.asarray(x0), f.d0.cov)
    names = {fl.name for fl in dataclasses.fields(f)}
    updates = {"d0": d0}
    if "R1" in names:
        updates["R1"] = jnp.asarray(R1)
    if "R2" in names:  # linear KF / EnKF keep R2 as a direct field
        updates["R2"] = jnp.asarray(R2)
        return f.replace(**updates)
    # EKF/UKF-style filters keep R2 inside the measurement model
    mm = f.measurement_model.replace(R2=jnp.asarray(R2))
    return f.replace(measurement_model=mm, **updates)


# ---------------------------------------------------------------------------
# Prediction-error residuals (smoothing.jl:176-217)
# ---------------------------------------------------------------------------


def prediction_errors(f, u, y, p=None, lam=1.0, *, loglik: bool = False,
                      offset: float = 0.0) -> jax.Array:
    """Stacked per-step residuals for Gauss-Newton optimization.

    - ``loglik=False``: ``sqrt(λ)·e_t`` per step → flat [T·ny] vector.
    - ``loglik=True``: whitened residuals ``L⁻¹e/√2`` plus one scalar
      ``sqrt(½(logdet S + ny·log 2π) + offset)`` per step → [T·(ny+1)];
      then ``‖res‖² = −loglik + T·offset`` (maximum likelihood as least
      squares, smoothing.jl:195-207).

    Differentiable end-to-end; the reference's negative-sqrt error branch
    becomes NaN residuals (increase ``offset``).
    """
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype)
    p = getattr(f, "p", None) if p is None else p
    Ts = getattr(f, "Ts", 1.0)
    tvec = jnp.arange(T) * Ts
    state0 = f.init()
    lam = jnp.asarray(lam, dtype=y.dtype)
    W = jnp.sqrt(lam)

    def step(state, inp):
        uk, yk, tk = inp
        state, info = f.update(state, uk, yk, p, tk)
        if loglik:
            ny = yk.shape[-1]
            r = jax.scipy.linalg.solve_triangular(info.Schol, info.e, lower=True)
            r = r / jnp.sqrt(jnp.asarray(2.0, r.dtype))
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(info.Schol)))
            c = 0.5 * (logdet + ny * _LOG2PI) + offset
            res = jnp.concatenate([r, jnp.sqrt(c)[None]])
        else:
            res = W * info.e if W.ndim < 2 else W @ info.e
        return state, res

    _, res = jax.lax.scan(step, state0, (u_seq, y, tvec))
    return res.reshape(-1)


# ---------------------------------------------------------------------------
# PMMH (smoothing.jl:266-347)
# ---------------------------------------------------------------------------


def naive_sampler(theta0, scale: float = 0.1):
    """Gaussian random-walk proposal with per-component scale 0.1·|θ₀|
    (smoothing.jl:292-295)."""
    theta0 = jnp.asarray(theta0)
    if bool(jnp.any(theta0 == 0)):
        raise ValueError(
            "naive_sampler requires a nonzero initial parameter vector"
        )
    std = scale * jnp.abs(theta0)

    def draw(theta, key):
        return theta + std * jax.random.normal(key, theta.shape, theta.dtype)

    return draw


def log_likelihood_fun(filter_from_parameters: Callable, priors: Sequence,
                       u, y, p=None, **kwargs) -> Callable:
    """``θ → log p(y|θ) + log p(θ)`` (smoothing.jl:266-282).

    ``filter_from_parameters(θ)`` builds a filter pytree; ``priors`` is a
    sequence of objects with ``logpdf`` (one per parameter).  Non-finite
    filter likelihoods map to -Inf (the reference's try/catch).
    """

    def ll(theta, key=None):
        theta = jnp.asarray(theta)
        lp = sum(
            jnp.sum(priors[i].logpdf(theta[i])) for i in range(len(priors))
        )
        f = filter_from_parameters(theta)
        if key is not None:
            lly = loglik(f, u, y, p, key=key, **kwargs)
        else:
            lly = loglik(f, u, y, p, **kwargs)
        total = lp + lly
        return jnp.where(jnp.isfinite(total), total, -jnp.inf)

    return ll


def metropolis(ll: Callable, R: int, theta0, draw=None, key=None,
               ll_takes_key: bool = False):
    """Marginal Metropolis–Hastings chain (smoothing.jl:311-330) as one
    `lax.scan` — the whole chain jit-compiles, including the filter runs.

    ``ll_takes_key=True`` passes a fresh PRNG key to ``ll`` per iteration
    (needed for particle-filter likelihoods — PMMH proper).
    Returns ``(thetas [R, nθ], lls [R])``.
    """
    theta0 = jnp.asarray(theta0)
    if key is None:
        key = jax.random.PRNGKey(0)
    if draw is None:
        draw_fn = naive_sampler(theta0)
    else:
        draw_fn = draw

    k0, key = jax.random.split(key)
    ll0 = ll(theta0, k0) if ll_takes_key else ll(theta0)

    def step(carry, k):
        theta, llv = carry
        kd, ka, kl = jax.random.split(k, 3)
        prop = draw_fn(theta, kd)
        llp = ll(prop, kl) if ll_takes_key else ll(prop)
        accept = jnp.log(jax.random.uniform(ka, (), llv.dtype)) < llp - llv
        theta = jnp.where(accept, prop, theta)
        llv = jnp.where(accept, llp, llv)
        return (theta, llv), (theta, llv)

    keys = jax.random.split(key, R - 1)
    _, (thetas, lls) = jax.lax.scan(step, (theta0, ll0), keys)
    thetas = jnp.concatenate([theta0[None], thetas], axis=0)
    lls = jnp.concatenate([ll0[None], lls], axis=0)
    return thetas, lls


def metropolis_parallel(burnin: int, ll: Callable, R: int, theta0, draw=None,
                        key=None, n_chains: int = 8, ll_takes_key: bool = False,
                        mesh=None, axis_name: str = None):
    """`metropolis_threaded` analogue (smoothing.jl:335-347): ``n_chains``
    independent chains via `vmap`, post-burn-in samples concatenated to
    [(R-burnin)·n_chains, nθ+1] with the log-likelihood in the last column.

    With ``mesh`` given, the chain axis is placed on the mesh via
    `shard_map` — the reference's thread-parallel chains map onto the
    device bank/DCN axis (SURVEY §5): each device runs its
    ``n_chains / n_devices`` chains locally with zero communication.
    ``n_chains`` must be divisible by the mesh axis size.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, n_chains)
    if draw is None:
        # resolve the default proposal eagerly: naive_sampler checks
        # theta0 concretely, which must happen outside shard_map tracing
        draw = naive_sampler(theta0)

    def one(k):
        return metropolis(ll, R, theta0, draw, key=k, ll_takes_key=ll_takes_key)

    if mesh is not None:
        from functools import partial as _partial
        from jax.sharding import PartitionSpec as _P

        ax = mesh.axis_names[0] if axis_name is None else axis_name
        S = int(np.prod([mesh.shape[a] for a in (ax,)]))
        if n_chains % S != 0:
            raise ValueError(
                f"n_chains={n_chains} must be divisible by the mesh axis "
                f"size {S}")

        @_partial(jax.shard_map, mesh=mesh, in_specs=_P(ax),
                  out_specs=(_P(ax), _P(ax)), check_vma=False)
        def run(keys_loc):
            return jax.vmap(one)(keys_loc)

        thetas, lls = run(keys)
    else:
        thetas, lls = jax.vmap(one)(keys)  # [C, R, nθ], [C, R]
    thetas = thetas[:, burnin:, :]
    lls = lls[:, burnin:]
    out = jnp.concatenate([thetas, lls[..., None]], axis=-1)
    return out.reshape(-1, out.shape[-1])


# ---------------------------------------------------------------------------
# Covariance autotuning (ext/LowLevelParticleFiltersLSOptExt.jl:44-257)
# ---------------------------------------------------------------------------


def _iw_neglogprior(Sigma, v, Psi):
    """Exact Inverse-Wishart negative log-density (up to a constant):
    ``(v+n+1)/2·logdet Σ + ½·tr(Ψ Σ⁻¹)``.

    The reference folds this into least-squares residuals via
    ``sqrt(|logdet Σ|)`` (LSOptExt.jl:19-42), which distorts the prior
    whenever logdet Σ < 0; here the penalty enters the Gauss-Newton step
    exactly through its gradient and Hessian instead.
    """
    n = Sigma.shape[-1]
    L = jnp.linalg.cholesky(Sigma)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    tr = jnp.trace(jax.scipy.linalg.cho_solve((L, True), Psi))
    return (v + n + 1) / 2.0 * logdet + 0.5 * tr


def autotune_covariances(
    f,
    u,
    y,
    p=None,
    *,
    diagonal: bool = True,
    optimize_x0: bool = False,
    offset: float = 0.0,
    iters: int = 50,
    lm_lambda0: float = 1e-2,
    v_R1: Optional[float] = None,
    v_R2: Optional[float] = None,
    verbose: bool = False,
):
    """MLE/MAP tuning of (R1, R2[, x0]) by Levenberg–Marquardt on the
    whitened prediction-error residuals (LSOptExt.jl:44-257).

    - ``diagonal=True``: optimize log-diagonals (positivity for free);
      otherwise the upper-triangular Cholesky factors (R = TᵀT).
    - ``v_R1``/``v_R2``: Inverse-Wishart prior dof for MAP estimation
      (prior mean = the filter's current covariances).
    - The LM loop is a fixed-iteration Python loop over jitted
      residual/Jacobian evaluations (`jax.jacfwd` through the filter scan).

    Returns ``(f_opt, info_dict)``.
    """
    R1_0 = jnp.asarray(f.R1)
    R2_0 = jnp.asarray(f.R2)
    x0_0 = f.d0.mean
    nw, ny = R1_0.shape[-1], R2_0.shape[-1]

    if v_R1 is not None and v_R1 <= nw - 1:
        raise ValueError(f"v_R1 must be > nw-1 = {nw-1}")
    if v_R2 is not None and v_R2 <= ny - 1:
        raise ValueError(f"v_R2 must be > ny-1 = {ny-1}")
    Psi1 = (v_R1 - nw - 1) * R1_0 if v_R1 is not None else None
    Psi2 = (v_R2 - ny - 1) * R2_0 if v_R2 is not None else None

    if diagonal:
        th_R1 = jnp.log(jnp.diagonal(R1_0))
        th_R2 = jnp.log(jnp.diagonal(R2_0))
        unpack_R1 = lambda th: jnp.diag(jnp.exp(th))
        unpack_R2 = lambda th: jnp.diag(jnp.exp(th))
    else:
        th_R1 = invtriangular(jnp.linalg.cholesky(R1_0).T)
        th_R2 = invtriangular(jnp.linalg.cholesky(R2_0).T)
        unpack_R1 = lambda th: (lambda T_: T_.T @ T_)(triangular(th))
        unpack_R2 = lambda th: (lambda T_: T_.T @ T_)(triangular(th))

    n1, n2 = th_R1.shape[0], th_R2.shape[0]
    theta0 = jnp.concatenate(
        [th_R1, th_R2] + ([x0_0] if optimize_x0 else [])
    )

    def build(theta):
        R1 = unpack_R1(theta[:n1])
        R2 = unpack_R2(theta[n1:n1 + n2])
        x0 = theta[n1 + n2:] if optimize_x0 else x0_0
        return reconstruct_filter(f, R1, R2, x0), R1, R2

    def residuals(theta):
        fi, _, _ = build(theta)
        return prediction_errors(fi, u, y, p, loglik=True, offset=offset)

    def prior(theta):
        _, R1, R2 = build(theta)
        pe = jnp.asarray(0.0, theta.dtype)
        if Psi1 is not None:
            pe = pe + _iw_neglogprior(R1, v_R1, Psi1)
        if Psi2 is not None:
            pe = pe + _iw_neglogprior(R2, v_R2, Psi2)
        return pe

    has_prior = Psi1 is not None or Psi2 is not None
    res_jac = jax.jit(lambda th: (residuals(th), jax.jacfwd(residuals)(th)))
    prior_gh = jax.jit(lambda th: (prior(th), jax.grad(prior)(th), jax.hessian(prior)(th)))
    cost = jax.jit(lambda th: 0.5 * jnp.sum(residuals(th) ** 2) + prior(th))

    theta = theta0
    lam = lm_lambda0
    c = float(cost(theta))
    for it in range(iters):
        r, J = res_jac(theta)
        JtJ = J.T @ J
        g = J.T @ r
        if has_prior:
            _, gp, Hp = prior_gh(theta)
            g = g + gp
            JtJ = JtJ + Hp
        step = jnp.linalg.solve(
            JtJ + lam * jnp.diag(jnp.maximum(jnp.abs(jnp.diagonal(JtJ)), 1e-12)), g
        )
        cand = theta - step
        c_new = float(cost(cand))
        if np.isfinite(c_new) and c_new < c:
            theta, c = cand, c_new
            lam = max(lam / 3.0, 1e-10)
        else:
            lam = min(lam * 5.0, 1e8)
        if verbose:
            print(f"iter {it:3d}  cost {c:.6e}  lambda {lam:.1e}")
        if float(jnp.max(jnp.abs(step))) < 1e-10:
            break

    f_opt, R1, R2 = build(theta)
    ssq = float(jnp.sum(residuals(theta) ** 2))  # = -loglik + T·offset
    info = {
        "R1": R1,
        "R2": R2,
        "x0": theta[n1 + n2:] if optimize_x0 else x0_0,
        "cost": c,
        "theta": theta,
        "neg_loglik": ssq - np.asarray(y).shape[0] * offset,
    }
    return f_opt, info
