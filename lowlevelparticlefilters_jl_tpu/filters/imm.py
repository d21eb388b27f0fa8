"""Interacting Multiple Models (IMM) filter.

A JAX re-design of the reference's src/imm.jl (struct :3-15, ctor
:49-67, interact! :86-117, correct! :139-163, combine! :170-190, update!
:214-220, forward_trajectory :271-297).

The mode bank is a static tuple of Kalman-type filters — mode count is
small and known at trace time, so the per-mode loop unrolls into one fused
XLA computation (no dynamic dispatch).  All mode states advance in
lock-step inside a single `lax.scan`; the mode-probability update uses the
same stable log-sum-exp as the particle weights (imm.jl:158-161).  Modes
with zero mixing probability keep their own state ("dead" modes evolve
untouched, imm.jl:91-94) via a `where` select — no control flow.

Mode states must expose Gaussian moments (``.x``/``.R``, i.e. `KFState`) —
KF/EKF/UKF/IEKF banks compose; square-root filters store a Cholesky factor
and cannot be moment-mixed (same implicit restriction as the reference).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize
from ..ops.logsumexp import logsumexp_normalize
from ..utils.signal_names import SignalNames
from ..utils.struct import struct, field, static_field
from ..trajectory import _as_u_seq
from .base import AbstractFilter
from .kalman import KalmanInfo


@struct
class IMMState:
    """Tuple of per-mode filter states + mode probabilities ``mu``."""

    states: tuple = field()
    mu: jax.Array = field()
    t: jax.Array = field(default=0)


@struct
class IMMInfo:
    """`correct` outputs: combined ll, per-mode lls, per-mode infos."""

    ll: jax.Array = field()
    lls: jax.Array = field()
    infos: tuple = field()


@struct
class InteractingMultipleModels(AbstractFilter):
    """IMM over a bank of Kalman-type filters (imm.jl:18-67).

    - ``models``: tuple of filters (state semantics must agree across modes)
    - ``P``: mode-transition matrix, rows sum to 1 (P[i,j]: i → j)
    - ``mu0``: initial mode probabilities
    - ``interact``: run the interaction step inside `update` (imm.jl:50)
    """

    models: tuple = field()
    P: jax.Array = field()
    mu0: jax.Array = field()
    p: Any = field(default=None)
    interact: bool = static_field(default=True)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "models", tuple(self.models))
        o(self, "P", jnp.asarray(self.P))
        o(self, "mu0", jnp.asarray(self.mu0))
        n = len(self.models)
        if self.P.shape != (n, n):
            raise ValueError("P must be (n_modes, n_modes)")
        if self.mu0.shape != (n,):
            raise ValueError("mu0 must have one entry per model")
        # row-stochastic / probability-vector checks (imm.jl:54-58).
        # Skipped under tracing: constructing an IMM inside jit (e.g. a
        # jitted parameter-tuning loss rebuilding the filter per call)
        # lifts even constant arrays to tracers.
        if not isinstance(
            jnp.sum(self.mu0) + jnp.sum(self.P), jax.core.Tracer
        ):
            if not bool(jnp.allclose(jnp.sum(self.mu0), 1.0, atol=1e-6)):
                raise ValueError("mu0 must sum to 1")
            if not bool(jnp.allclose(jnp.sum(self.P, axis=1), 1.0, atol=1e-6)):
                raise ValueError("P rows must sum to 1")
        if self.names is None:
            o(self, "names", getattr(self.models[0], "names", None))

    @property
    def n_modes(self) -> int:
        return len(self.models)

    @property
    def Ts(self) -> float:
        return self.models[0].Ts

    # ------------------------------------------------------------------
    def init(self, key=None) -> IMMState:
        states = tuple(m.init() for m in self.models)
        return IMMState(states=states, mu=self.mu0, t=jnp.asarray(0, jnp.int32))

    def state(self, state: IMMState) -> jax.Array:
        """Combined (moment-matched) state mean (imm.jl:181-183)."""
        xs = jnp.stack([m.state(s) for m, s in zip(self.models, state.states)])
        return jnp.einsum("j,jd->d", state.mu, xs)

    def covariance(self, state: IMMState) -> jax.Array:
        """Combined covariance incl. spread-of-means term (imm.jl:185-189)."""
        xs = jnp.stack([m.state(s) for m, s in zip(self.models, state.states)])
        Rs = jnp.stack([m.covariance(s) for m, s in zip(self.models, state.states)])
        x = jnp.einsum("j,jd->d", state.mu, xs)
        d = xs - x
        return jnp.einsum("j,jik->ik", state.mu, Rs) + jnp.einsum(
            "j,ji,jk->ik", state.mu, d, d
        )

    def mode_probabilities(self, state: IMMState) -> jax.Array:
        return state.mu

    # ------------------------------------------------------------------
    def interact_(self, state: IMMState) -> IMMState:
        """Mixing step (imm.jl:86-117): each mode's moments are re-mixed
        with weights ``μ_ij = P[i,j] μ_i / c_j``; dead modes (c_j = 0)
        keep their own moments."""
        mu, P = state.mu, self.P
        xs = jnp.stack([m.state(s) for m, s in zip(self.models, state.states)])
        Rs = jnp.stack([m.covariance(s) for m, s in zip(self.models, state.states)])
        cj = P.T @ mu  # [n]
        # Near-dead counts as dead (not just cj == 0): with a sticky P a
        # dying mode's cj decays exponentially, and the quotient-rule
        # gradient of mu/cj overflows (inf·0 → NaN) long before cj
        # underflows — the where() below only cuts the gradient path when
        # the 1.0 branch is selected.  Mixing weights below 1e-6 are
        # numerically irrelevant to the mixed moments anyway.
        alive_j = cj > 1e-6
        safe_cj = jnp.where(alive_j, cj, 1.0)
        muij = jnp.where(alive_j[None, :], P * mu[:, None] / safe_cj[None, :], 0.0)
        new_x = jnp.einsum("ij,id->jd", muij, xs)
        d = xs[:, None, :] - new_x[None, :, :]  # [i, j, d]
        dd = jnp.einsum("ija,ijb->ijab", d, d)
        new_R = symmetrize(
            jnp.einsum("ij,ijab->jab", muij, dd)
            + jnp.einsum("ij,iab->jab", muij, Rs)
        )
        # dead modes evolve untouched (imm.jl:91-94)
        alive = alive_j[:, None]
        new_x = jnp.where(alive, new_x, xs)
        new_R = jnp.where(alive[..., None], new_R, Rs)
        states = tuple(
            s.replace(x=new_x[j], R=new_R[j]) for j, s in enumerate(state.states)
        )
        return state.replace(states=states)

    def predict(self, state: IMMState, u=None, p=None, t=None, **kw) -> IMMState:
        """Per-mode time update (imm.jl:123-128)."""
        p = self.p if p is None else p
        states = tuple(
            m.predict(s, u, p, t, **kw) for m, s in zip(self.models, state.states)
        )
        return IMMState(states=states, mu=state.mu, t=state.t + 1)

    def correct(self, state: IMMState, u, y, p=None, t=None, **kw):
        """Per-mode measurement update + mode-probability update
        (imm.jl:139-163): ``w = lls + log(Pᵀμ)`` normalized by logsumexp."""
        p = self.p if p is None else p
        outs = [m.correct(s, u, y, p, t, **kw) for m, s in zip(self.models, state.states)]
        states = tuple(o[0] for o in outs)
        infos = tuple(o[1] for o in outs)
        lls = jnp.stack([i.ll for i in infos])
        muP = self.P.T @ state.mu
        w = lls + jnp.log(jnp.maximum(muP, jnp.finfo(lls.dtype).tiny))
        _, mu, ll = logsumexp_normalize(w)
        return (
            IMMState(states=states, mu=mu, t=state.t),
            IMMInfo(ll=ll, lls=lls, infos=infos),
        )

    def update(self, state: IMMState, u, y, p=None, t=None, *, interact=None, **kw):
        """correct → (combine implicit) → interact → predict (imm.jl:214-220)."""
        do_interact = self.interact if interact is None else interact
        state, info = self.correct(state, u, y, p, t, **kw)
        if do_interact:
            state = self.interact_(state)
        state = self.predict(state, u, p, t)
        return state, info

    # ------------------------------------------------------------------
    def forward_trajectory(self, u, y, p=None, *, interact=None, **_ignored):
        """Batch filtering (imm.jl:271-297): the per-step combined moments
        land in ``x/xt/R/Rt``; mode probabilities in ``sol.extra`` [T, n]."""
        from ..utils.solutions import KalmanFilteringSolution

        y = jnp.asarray(y)
        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype)
        p = self.p if p is None else p
        do_interact = self.interact if interact is None else interact
        tvec = jnp.arange(T) * self.Ts
        state0 = self.init()

        def step(state, inp):
            uk, yk, tk = inp
            x_pred, R_pred = self.state(state), self.covariance(state)
            state, info = self.correct(state, uk, yk, p, tk)
            x_filt, R_filt = self.state(state), self.covariance(state)
            mu = state.mu
            if do_interact:
                state = self.interact_(state)
            state = self.predict(state, uk, p, tk)
            e = jnp.zeros_like(yk)  # innovation of the combined model n/a per-mode
            ok = jnp.all(jnp.isfinite(x_filt))
            return state, (x_pred, R_pred, x_filt, R_filt, info.ll, mu, ok)

        _, (x, R, xt, Rt, lls, mus, ok) = jax.lax.scan(step, state0, (u_seq, y, tvec))
        return KalmanFilteringSolution(
            u=u_seq, y=y, x=x, xt=xt, R=R, Rt=Rt, ll=jnp.sum(lls),
            e=None, K=None, S=None, extra=mus, t=tvec, ok=ok,
        )

    def loglik(self, u, y, p=None, **kwargs):
        return self.forward_trajectory(u, y, p, **kwargs).ll

    # -- simulation hooks (imm.jl:240-252): μ-weighted averages ----------
    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        keys = jax.random.split(key, self.n_modes)
        xs = jnp.stack([
            m.sample_state(k, x, u, p, t, noise=noise)
            for m, k in zip(self.models, keys)
        ])
        return jnp.einsum("j,jd->d", self.mu0, xs)

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        keys = jax.random.split(key, self.n_modes)
        ys = jnp.stack([
            m.sample_measurement(k, x, u, p, t, noise=noise)
            for m, k in zip(self.models, keys)
        ])
        return jnp.einsum("j,jd->d", self.mu0, ys)


IMM = InteractingMultipleModels


def interact(imm: InteractingMultipleModels, state: IMMState) -> IMMState:
    """Flat-function IMM mixing step — reference-export parity for
    ``interact!(imm)`` (src/LowLevelParticleFilters.jl:6, imm.jl:86-117).
    Functional: returns the mixed state instead of mutating."""
    return imm.interact_(state)


def combine(imm: InteractingMultipleModels, state: IMMState):
    """Flat-function IMM moment combination — reference-export parity for
    ``combine!(imm)`` (src/LowLevelParticleFilters.jl:6, imm.jl:180-196).
    Returns ``(x, R)``: the μ-weighted mean and covariance (including the
    spread-of-means term) of the mode-conditional estimates."""
    return imm.state(state), imm.covariance(state)
