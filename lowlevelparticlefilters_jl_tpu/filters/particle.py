"""Particle filters: bootstrap, advanced (non-additive noise), auxiliary.

A JAX re-design of the reference's src/PFtypes.jl and the particle
branches of src/filtering.jl:140-234.  The reference's per-particle loops
(PFtypes.jl:107-139, optionally `Threads.@threads` :229-231) become `vmap`
over a [N, nx] particle array; weight normalization is a fused
max/exp/sum pass (ops/logsumexp.py); resampling is prefix-sum +
closed-form slot counting (ops/resample.py).  The Neff-triggered resampling branch
(resample.jl:5-10) is a `lax.cond` so the resampling cost is only paid on
steps that actually fire while the scan body stays shape-static.

PRNG keys are threaded explicitly through :class:`PFState` — the functional
replacement for the per-filter `rng` field (PFtypes.jl:30).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.logsumexp import logsumexp_normalize, expnormalize, effective_particles
from ..ops.mvnormal import MvNormal, as_mvnormal
from ..ops.resample import resample, resample_systematic_gather
from ..utils.solutions import ParticleFilteringSolution
from ..utils.struct import struct, field, static_field
from ..trajectory import _as_u_seq
from .base import AbstractParticleFilter


@struct
class PFState:
    """Particle-filter state pytree (PFtypes.jl:8-19).

    - ``x``  : particles, [N, nx]
    - ``w``  : normalized log-weights, [N]
    - ``we`` : normalized exp-weights, [N]
    - ``t``  : step counter
    - ``key``: PRNG key (explicit replacement for the stored RNG)
    """

    x: jax.Array = field()
    w: jax.Array = field()
    we: jax.Array = field()
    t: jax.Array = field()
    key: jax.Array = field()


@struct
class PFInfo:
    """Per-step outputs of `correct` — ``(ll, e)`` with e always 0 for
    particle filters (filtering.jl:156-168)."""

    ll: jax.Array = field()
    e: jax.Array = field()


def _uniform_weights(N: int, dtype) -> tuple[jax.Array, jax.Array]:
    w = jnp.full((N,), -jnp.log(jnp.asarray(N, dtype=dtype)), dtype=dtype)
    we = jnp.full((N,), 1.0 / N, dtype=dtype)
    return w, we


class _ParticleCommon(AbstractParticleFilter):
    """Shared init / resample / trajectory logic for all particle filters."""

    def init(self, key: jax.Array) -> PFState:
        """`reset!` analogue (filtering.jl:4-14): draw N initial particles."""
        key, k0 = jax.random.split(key)
        d0 = self.initial_density
        x = d0.sample(k0, (self.N,))
        w, we = _uniform_weights(self.N, x.dtype)
        return PFState(x=x, w=w, we=we, t=jnp.asarray(0, jnp.int32), key=key)

    # -- resample-or-not, shape-static (filtering.jl:140-153) ------------
    def _maybe_resample(self, state: PFState):
        """Resampled particles + (did-resample?, key), honoring the Neff
        trigger (resample.jl:5-10).

        The Neff trigger is a `lax.cond`: XLA executes only the taken
        branch at runtime, so the resampling cost (dominated by the
        permutation) is paid only on the steps that
        actually resample — with the reference-default threshold 0.1 that
        is every ~10-30 steps.
        """
        N = self.N
        key, kr = jax.random.split(state.key)
        exact = getattr(self, "exact_resample", False)

        def do_resample(ops):
            x, we = ops
            if self.resampling_strategy == "systematic" and not exact:
                return resample_systematic_gather(x, we, kr)
            j = resample(we, kr, N, strategy=self.resampling_strategy)
            return x[j]

        if self.resample_threshold >= 1.0:
            return do_resample((state.x, state.we)), jnp.asarray(True), key
        neff = effective_particles(state.we)
        do = neff < self.resample_threshold * N
        x = jax.lax.cond(do, do_resample, lambda ops: ops[0], (state.x, state.we))
        return x, do, key

    def forward_trajectory(self, u, y, p=None, *, pre_correct_cb=None,
                           post_correct_cb=None, pre_predict_cb=None,
                           post_predict_cb=None, key: jax.Array = None,
                           state0: PFState = None):
        """PF batch filtering (filtering.jl:343-365): correct → save → predict."""
        y = jnp.asarray(y)
        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype)
        p = self.p if p is None else p
        if state0 is None:
            if key is None:
                raise ValueError("provide key= (or state0=) for particle filtering")
            state0 = self.init(key)
        tvec = jnp.arange(T) * self.Ts

        def step(state, inp):
            uk, yk, tk = inp
            if pre_correct_cb:
                pre_correct_cb(self, state, uk, yk, p, tk)
            state, info = self.correct(state, uk, yk, p, tk)
            if post_correct_cb:
                out = post_correct_cb(self, state, info, uk, yk, p, tk)
                if out is not None:
                    state = out
            ys = (info.ll, state.x, state.w, state.we)
            if pre_predict_cb:
                pre_predict_cb(self, state, uk, yk, p, tk, info)
            state = self.predict(state, uk, p, tk)
            if post_predict_cb:
                out = post_predict_cb(self, state, uk, yk, p, tk)
                if out is not None:
                    state = out
            return state, ys

        _, (lls, xs, ws, wes) = jax.lax.scan(step, state0, (u_seq, y, tvec))
        return ParticleFilteringSolution(
            u=u_seq, y=y, x=xs, w=ws, we=wes, ll=jnp.sum(lls)
        )

    def loglik(self, u, y, p=None, *, key: jax.Array = None,
               state0: PFState = None, method: str = "auto"):
        """Low-memory total log-likelihood (smoothing.jl:227-230): one
        ``lax.scan`` of the update step.  ``method`` is accepted for
        parity with the Kalman verbs; every value runs the same scan."""
        from ..routing import _check_method, _record

        _check_method(method)
        _record("loglik", "xla_scan")
        y = jnp.asarray(y)
        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype)
        p = self.p if p is None else p
        if state0 is None:
            state0 = self.init(key)
        tvec = jnp.arange(T) * self.Ts

        def step(state, inp):
            uk, yk, tk = inp
            state, info = self.update(state, uk, yk, p, tk)
            return state, info.ll

        _, lls = jax.lax.scan(step, state0, (u_seq, y, tvec))
        return jnp.sum(lls)

    def smooth(self, u, y, p=None, *, M: int, key: jax.Array):
        """FFBS particle smoother (smoothing.jl:104-143)."""
        from ..smoothing import ffbs_smooth

        kf_, ks = jax.random.split(key)
        sol = self.forward_trajectory(u, y, p, key=kf_)
        return ffbs_smooth(self, sol, M, ks, u=u, y=y, p=p)

    # -- statistics -------------------------------------------------------
    def weighted_mean(self, state: PFState) -> jax.Array:
        return jnp.einsum("n,nd->d", state.we, state.x)

    def effective_particles(self, state: PFState) -> jax.Array:
        return effective_particles(state.we)


@struct
class ParticleFilter(_ParticleCommon):
    """Bootstrap particle filter with additive noise (PFtypes.jl:21-81).

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive process noise)
    - ``measurement``: ``g(x, u, p, t) -> ŷ`` (additive measurement noise)
    - densities: any object with ``logpdf``/``sample`` (MvNormal built-in)
    - ``exact_resample=True`` routes systematic resampling through the
      exact index-gather path instead of the float scatter+prefix-sum
      reconstruction (O(sqrt(N)·eps) error) — use for particles with
      exact/discrete state components.
    """

    N: int = static_field()
    dynamics: Callable = static_field()
    measurement: Callable = static_field()
    dynamics_density: Any = field(default=None)
    measurement_density: Any = field(default=None)
    initial_density: Any = field(default=None)
    p: Any = field(default=None)
    resample_threshold: float = static_field(default=0.1)
    resampling_strategy: str = static_field(default="systematic")
    exact_resample: bool = static_field(default=False)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)

    def __post_init__(self):
        o = object.__setattr__
        for name in ("dynamics_density", "measurement_density", "initial_density"):
            v = getattr(self, name)
            if v is None:
                continue
            # Vector density objects (MvNormal, TupleProduct, ...) pass
            # through — the reference's ParticleFilter accepts ANY
            # density (PFtypes.jl measurement_density::Any); bare
            # covariance arrays coerce to zero-mean Gaussians.
            if (hasattr(v, "logpdf") and hasattr(v, "sample")
                    and hasattr(v, "dim") and not hasattr(v, "shape")):
                continue
            o(self, name, as_mvnormal(v))

    @property
    def nx(self) -> int:
        return self.initial_density.dim

    # -- measurement update (PFtypes.jl:107-120, filtering.jl:164-168) ----
    def correct(self, state: PFState, u, y, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        y = jnp.asarray(y)
        g = self.measurement
        yhat = jax.vmap(lambda xi: g(xi, u, p, t))(state.x)  # [N, ny]
        logp = self.measurement_density.logpdf(y - yhat)  # [N]
        # missing measurements (NaN) leave weights untouched (PFtypes.jl:109)
        missing = jnp.any(jnp.isnan(y))
        w = jnp.where(missing, state.w, state.w + logp)
        w, we, ll = logsumexp_normalize(w)
        ll = jnp.where(missing, jnp.zeros_like(ll), ll)
        return state.replace(w=w, we=we), PFInfo(ll=ll, e=jnp.zeros_like(y))

    # -- propagation (filtering.jl:140-153, PFtypes.jl:122-139) ----------
    def predict(self, state: PFState, u=None, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, did_resample, key = self._maybe_resample(state)
        f = self.dynamics
        xn = jax.vmap(lambda xi: f(xi, u, p, t))(x)
        if self.dynamics_density is not None:
            key, kn = jax.random.split(key)
            xn = xn + self.dynamics_density.sample(kn, (self.N,))
        w0, we0 = _uniform_weights(self.N, state.w.dtype)
        w = jnp.where(did_resample, w0, state.w)
        we = jnp.where(did_resample, we0, state.we)
        return PFState(x=xn, w=w, we=we, t=state.t + 1, key=key)

    # -- simulation hooks (PFtypes.jl:302-306) ----------------------------
    def sample_initial(self, key, p=None, noise=True):
        return self.initial_density.sample(key) if noise else self.initial_density.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise and self.dynamics_density is not None:
            xn = xn + self.dynamics_density.sample(key)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        y = self.measurement(x, u, p, t)
        if noise and self.measurement_density is not None:
            y = y + self.measurement_density.sample(key)
        return y


@struct
class AdvancedParticleFilter(_ParticleCommon):
    """Particle filter with non-additive noise (PFtypes.jl:162-210).

    - ``dynamics``: ``f(x, u, p, t, key) -> x⁺``; ``key is None`` means
      propagate without noise (the reference's ``noise::Bool`` flag).
    - ``measurement``: ``g(x, u, p, t, key) -> y`` (key None = noiseless)
    - ``measurement_likelihood``: ``gl(x, u, y, p, t) -> log p(y | x)``
    """

    N: int = static_field()
    dynamics: Callable = static_field()
    measurement: Callable = static_field()
    measurement_likelihood: Callable = static_field()
    initial_density: Any = field(default=None)
    p: Any = field(default=None)
    resample_threshold: float = static_field(default=0.5)
    resampling_strategy: str = static_field(default="systematic")
    exact_resample: bool = static_field(default=False)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)

    def __post_init__(self):
        if self.initial_density is not None:
            object.__setattr__(
                self, "initial_density", as_mvnormal(self.initial_density)
            )

    @property
    def nx(self) -> int:
        return self.initial_density.dim

    def correct(self, state: PFState, u, y, p=None, t=None, g: Callable = None):
        """Weight update via the user likelihood (PFtypes.jl:226-239).

        A custom ``g`` supports per-sensor updates like the reference's
        `correct!(...; g = custom_likelihood)`.
        """
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        y = jnp.asarray(y)
        gl = self.measurement_likelihood if g is None else g
        logp = jax.vmap(lambda xi: gl(xi, u, y, p, t))(state.x)
        missing = jnp.any(jnp.isnan(y))
        w = jnp.where(missing, state.w, state.w + logp)
        w, we, ll = logsumexp_normalize(w)
        ll = jnp.where(missing, jnp.zeros_like(ll), ll)
        return state.replace(w=w, we=we), PFInfo(ll=ll, e=jnp.zeros_like(y))

    def predict(self, state: PFState, u=None, p=None, t=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, did_resample, key = self._maybe_resample(state)
        key, kn = jax.random.split(key)
        keys = jax.random.split(kn, self.N)
        f = self.dynamics
        xn = jax.vmap(lambda xi, ki: f(xi, u, p, t, ki))(x, keys)
        w0, we0 = _uniform_weights(self.N, state.w.dtype)
        w = jnp.where(did_resample, w0, state.w)
        we = jnp.where(did_resample, we0, state.we)
        return PFState(x=xn, w=w, we=we, t=state.t + 1, key=key)

    def sample_initial(self, key, p=None, noise=True):
        return self.initial_density.sample(key) if noise else self.initial_density.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        return self.dynamics(x, u, p, t, key if noise else None)

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        return self.measurement(x, u, p, t, key if noise else None)


@struct
class AuxiliaryParticleFilter(_ParticleCommon):
    """Auxiliary particle filter wrapping a :class:`ParticleFilter` or
    :class:`AdvancedParticleFilter` (PFtypes.jl:38-49).

    The predict step folds the *next* measurement into first-stage weights
    λ evaluated at noiselessly-propagated particles (filtering.jl:195-234).
    `update(state, u, y, y1, ...)`; `forward_trajectory` handles the
    one-step lookahead automatically.
    """

    pf: Any = field()

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "pf"), name)

    def init(self, key):
        return self.pf.init(key)

    def correct(self, state: PFState, u, y, p=None, t=None):
        """Normalization only — the measurement enters in predict
        (filtering.jl:170-174)."""
        w, we, ll = logsumexp_normalize(state.w)
        return state.replace(w=w, we=we), PFInfo(
            ll=ll, e=jnp.zeros_like(jnp.asarray(y))
        )

    def predict(self, state: PFState, u, y1, p=None, t=None):
        inner = self.pf
        p = inner.p if p is None else p
        t = state.t * inner.Ts if t is None else t
        N = inner.N
        y1 = jnp.asarray(y1)

        if isinstance(inner, AdvancedParticleFilter):
            # Advanced variant (filtering.jl:219-234)
            xpred = jax.vmap(lambda xi: inner.dynamics(xi, u, p, t, None))(state.x)
            lam = jax.vmap(lambda xi: inner.measurement_likelihood(xi, u, y1, p, t))(xpred)
            w = state.w + lam
            we_b = expnormalize(w)
            key, kr = jax.random.split(state.key)
            if inner.resampling_strategy == "systematic" and not getattr(inner, "exact_resample", False):
                x_res = resample_systematic_gather(state.x, we_b, kr)
            else:
                j = resample(we_b, kr, N, strategy=inner.resampling_strategy)
                x_res = state.x[j]
            key, kn = jax.random.split(key)
            keys = jax.random.split(kn, N)
            xn = jax.vmap(lambda xi, ki: inner.dynamics(xi, u, p, t, ki))(
                x_res, keys
            )
            w0, we0 = _uniform_weights(N, state.w.dtype)
            return PFState(x=xn, w=w0, we=we0, t=state.t + 1, key=key)

        # Plain variant (filtering.jl:195-217)
        f, g, dg = inner.dynamics, inner.measurement, inner.measurement_density
        xpred = jax.vmap(lambda xi: f(xi, u, p, t))(state.x)  # noiseless
        lam = dg.logpdf(y1 - jax.vmap(lambda xi: g(xi, u, p, t))(xpred))
        w = state.w + lam
        we_b = expnormalize(w)
        key, kr = jax.random.split(state.key)
        if inner.resampling_strategy == "systematic" and not getattr(inner, "exact_resample", False):
            x = resample_systematic_gather(xpred, we_b, kr)
        else:
            j = resample(we_b, kr, N, strategy=inner.resampling_strategy)
            x = xpred[j]
        if inner.dynamics_density is not None:
            key, kn = jax.random.split(key)
            x = x + inner.dynamics_density.sample(kn, (N,))
        # Reference keeps the *unresampled* λ[i] (filtering.jl:210-212).
        lN = jnp.log(jnp.asarray(N, dtype=state.w.dtype))
        w_new = lam - lN
        we_new = expnormalize(w_new)
        return PFState(x=x, w=w_new, we=we_new, t=state.t + 1, key=key)

    def update(self, state, u, y, y1=None, p=None, t=None, **kw):
        """One APF step needs the next measurement ``y1``
        (filtering.jl:187-191); at the last step pass y1=None to fall back
        to a plain update."""
        state, info = self.correct(state, u, y, p, t)
        if y1 is not None:
            state = self.predict(state, u, y1, p, t)
        return state, info

    def forward_trajectory(self, u, y, p=None, *, key: jax.Array = None,
                           state0: PFState = None, **_ignored):
        """APF batch filtering with one-step lookahead (filtering.jl:367-384)."""
        y = jnp.asarray(y)
        T = y.shape[0]
        inner = self.pf
        u_seq = _as_u_seq(u, T, y.dtype)
        p = inner.p if p is None else p
        if state0 is None:
            state0 = self.init(key)
        tvec = jnp.arange(T) * inner.Ts
        y_next = jnp.concatenate([y[1:], y[-1:]], axis=0)
        is_last = jnp.arange(T) == T - 1

        def step(state, inp):
            uk, yk, y1k, tk, last = inp
            state, info = self.correct(state, uk, yk, p, tk)
            ys = (info.ll, state.x, state.w, state.we)
            pred = self.predict(state, uk, y1k, p, tk)
            # Skip the lookahead predict at the final step (filtering.jl:381)
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(last, a, b),
                state.replace(t=pred.t, key=pred.key),
                pred,
            )
            return state, ys

        _, (lls, xs, ws, wes) = jax.lax.scan(
            step, state0, (u_seq, y, y_next, tvec, is_last)
        )
        return ParticleFilteringSolution(
            u=u_seq, y=y, x=xs, w=ws, we=wes, ll=jnp.sum(lls)
        )

    def loglik(self, u, y, p=None, *, key=None, state0=None,
               method: str = "auto"):
        from ..routing import _record

        _record("loglik", "xla_scan")  # APF has no fused kernel
        return self.forward_trajectory(u, y, p, key=key, state0=state0).ll
