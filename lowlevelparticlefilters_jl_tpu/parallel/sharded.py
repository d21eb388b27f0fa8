"""Mesh-sharded particle filtering — the multi-chip execution layer.

The reference's only parallelism is shared-memory threads over the particle
loop (/root/reference/src/PFtypes.jl:229-231, 247-252) and threaded MCMC
chains (src/smoothing.jl:335-347).  The JAX equivalent shards the
*particle axis* over a `jax.sharding.Mesh` and uses collectives over the
device interconnect (NVLink between GPUs of one host, all to all):

- particle propagation and measurement weighting are embarrassingly parallel
  (no communication),
- the global weight normalization (`logsumexp!`, src/utils.jl:18-27) becomes
  `pmax` (stable offset) + `psum` (normalizer) — two scalar collectives,
- systematic resampling (src/resample.jl:17-36) needs the *global* CDF: the
  weight vector is `all_gather`-ed (N floats — cheap), each device computes
  its own slice of the global index vector, and particles are exchanged with
  one `all_gather` of the particle block (the gather-to-replicated regime,
  valid to N ≈ 1e6; see SURVEY.md §5).

Two usage modes:

1. **GSPMD (automatic)** — place `PFState` arrays with
   :func:`shard_pf_state` and call the ordinary `pf.update` under `jit`;
   XLA partitions the vmapped dynamics/weighting and inserts collectives
   for the reductions itself.
2. **shard_map (explicit)** — :func:`sharded_update` /
   :func:`sharded_forward_trajectory` spell out the collectives per the
   scaling-book recipe; use when you want guaranteed comm placement.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..filters.particle import PFInfo, PFState, _uniform_weights
from ..ops.logsumexp import effective_particles


def particle_mesh(n_devices: Optional[int] = None, axis_name: str = "particles") -> Mesh:
    """A 1-D device mesh over the particle axis."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), (axis_name,))


def shard_pf_state(state: PFState, mesh: Mesh, axis_name: str = "particles") -> PFState:
    """Place a PFState with particles/weights sharded over ``axis_name``.

    ``t`` and ``key`` are replicated (every device must hold the same key so
    the shared systematic-resampling offset agrees across shards).
    """
    sh = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())
    return PFState(
        x=jax.device_put(state.x, NamedSharding(mesh, P(axis_name, None))),
        w=jax.device_put(state.w, sh),
        we=jax.device_put(state.we, sh),
        t=jax.device_put(state.t, rep),
        key=jax.device_put(state.key, rep),
    )


# ---------------------------------------------------------------------------
# Explicit shard_map implementation
# ---------------------------------------------------------------------------


def _correct_local(pf, state, u, y, p, t, axis_name):
    """Per-shard measurement update with global logsumexp normalization."""
    y = jnp.asarray(y)
    if hasattr(pf, "measurement_likelihood"):  # AdvancedParticleFilter
        gl = pf.measurement_likelihood
        logp = jax.vmap(lambda xi: gl(xi, u, y, p, t))(state.x)
    else:
        g = pf.measurement
        yhat = jax.vmap(lambda xi: g(xi, u, p, t))(state.x)
        logp = pf.measurement_density.logpdf(y - yhat)
    missing = jnp.any(jnp.isnan(y))
    w = jnp.where(missing, state.w, state.w + logp)
    # distributed logsumexp: pmax offset, psum normalizer (utils.jl:18-27)
    offset = jax.lax.pmax(jnp.max(w), axis_name)
    we = jnp.exp(w - offset)
    s = jax.lax.psum(jnp.sum(we), axis_name)
    ll = jnp.log(s) + offset
    w = w - offset - jnp.log(s)
    we = we / s
    ll = jnp.where(missing, jnp.zeros_like(ll), ll)
    return state.replace(w=w, we=we), PFInfo(ll=ll, e=jnp.zeros_like(y))


def _resample_global(state, pf, axis_name, force_resample=False):
    """Global systematic resampling across shards.

    Returns the local slice of resampled particles.  The weight vector and
    the particle block are all-gathered (gather-to-replicated regime).
    ``force_resample`` skips the Neff gate (APF first-stage resampling
    fires unconditionally, filtering.jl:195-217).
    """
    n_shards = jax.lax.axis_size(axis_name)
    shard = jax.lax.axis_index(axis_name)
    M_loc = state.x.shape[0]
    N = M_loc * n_shards
    key, kr = jax.random.split(state.key)  # identical on all shards

    we_all = jax.lax.all_gather(state.we, axis_name, tiled=True)  # [N]
    bins = jnp.cumsum(we_all)
    total = bins[-1]
    r = jax.random.uniform(kr, (), dtype=we_all.dtype)
    i_loc = shard * M_loc + jnp.arange(M_loc, dtype=we_all.dtype)
    u_pts = (r + i_loc) / N * total
    j = jnp.clip(jnp.searchsorted(bins, u_pts, side="right"), 0, N - 1)

    x_all = jax.lax.all_gather(state.x, axis_name, tiled=True)  # [N, nx]
    x_res = x_all[j]
    # Effective-particle trigger on the global weights (resample.jl:5-10).
    if force_resample or pf.resample_threshold >= 1.0:
        do = jnp.asarray(True)
    else:
        do = effective_particles(we_all) < pf.resample_threshold * N
    x_out = jnp.where(do, x_res, state.x)
    w0, we0 = _uniform_weights(M_loc, state.w.dtype)
    lNratio = jnp.log(jnp.asarray(n_shards, state.w.dtype))
    # local shards hold N-normalized weights: log(1/N) = log(1/M_loc) - log(S)
    w = jnp.where(do, w0 - lNratio, state.w)
    we = jnp.where(do, we0 / n_shards, state.we)
    return x_out, w, we, key


def _resample_distributed(state, pf, axis_name, force_resample=False):
    """Global systematic resampling with O(N/devices) interconnect traffic.

    The gather-to-replicated path (:func:`_resample_global`) moves the full
    [N, nx] particle block over the interconnect and dies around N ≈ 1e6;
    this routine (cf. Murray, "Parallel resampling in the particle filter",
    arXiv:1301.4019 — PAPERS.md) exchanges only neighbor blocks:

    1. shard CDF offsets via one scalar all_gather (S floats),
    2. each source shard derives, from the counting-sort slot boundaries
       ``K_i = ceil(cdf_i·N/total − r)`` (ops/resample.py), the *global*
       owner index of every output slot in its ±1-shard window — the count
       identity ``owner(g) = s·M + #{local i : K_i ≤ g}`` needs no global
       CDF,
    3. two `ppermute`s ([M, nx] each) deliver the neighbor segments; each
       output slot is valid from exactly one source.

    If any shard's offspring slots escape its ±1 window (weight skew > one
    shard's worth — impossible once Neff-triggered resampling keeps weights
    balanced, but possible in adversarial inputs), every shard detects it
    via a psum'd flag and `lax.cond`s into a ring-rotation exchange that
    serves arbitrary skew in ≤ S-1 neighbor hops with O(M_loc) peak
    memory (see ``fallback`` below) — no gather-to-replicated [N, nx]
    block anywhere.

    Returns ``(x_out, w, we, key)`` like :func:`_resample_global`.
    """
    n_shards = jax.lax.axis_size(axis_name)
    if n_shards == 1:
        return _resample_global(state, pf, axis_name,
                                force_resample=force_resample)
    shard = jax.lax.axis_index(axis_name)
    M_loc = state.x.shape[0]
    N = M_loc * n_shards
    nx = state.x.shape[-1]
    key, kr = jax.random.split(state.key)  # identical on all shards

    # ---- shard CDF offsets (S scalars between devices) ------------------
    w_sum = jnp.sum(state.we)
    sums = jax.lax.all_gather(w_sum, axis_name)           # [S]
    total = jnp.sum(sums)
    offset = jnp.cumsum(sums) - sums                       # exclusive prefix
    O_s = offset[shard]

    # Neff trigger from global moments — no weight gather needed.
    sq = jax.lax.psum(jnp.sum(jnp.square(state.we)), axis_name)
    neff = (total * total) / sq
    if force_resample or pf.resample_threshold >= 1.0:
        do = jnp.asarray(True)
    else:
        do = neff < pf.resample_threshold * N

    # ---- local slot boundaries (global K values) ------------------------
    r = jax.random.uniform(kr, (), dtype=state.we.dtype)
    gbins = O_s + jnp.cumsum(state.we)
    K = jnp.ceil(gbins * N / total - r).astype(jnp.int32)  # [M_loc], global
    K = jnp.clip(K, 0, N)
    K_base = jnp.clip(jnp.ceil(O_s * N / total - r), 0, N).astype(jnp.int32)
    K_last = K[-1]

    # window of output slots this source can serve: [(s-1)M, (s+2)M)
    g0 = (shard - 1) * M_loc
    W = 3 * M_loc
    overflow = (K_base < g0) | (K_last > g0 + W)
    overflow = jax.lax.psum(overflow.astype(jnp.int32), axis_name) > 0

    def distributed(_):
        # counting sort inside the window: owner(g) = #{local i: K_i <= g}
        Kw = jnp.clip(K - g0, 0, W)                        # window coords
        hist = jnp.zeros((W + 1,), jnp.int32).at[Kw].add(1)
        j_loc = jnp.clip(jnp.cumsum(hist)[:-1], 0, M_loc - 1)  # [W]
        g = g0 + jnp.arange(W, dtype=jnp.int32)
        valid = (g >= K_base) & (g < K_last) & (g >= 0) & (g < N)
        seg = jnp.where(valid[:, None], state.x[j_loc], 0.0)   # [W, nx]

        left, mid, right = seg[:M_loc], seg[M_loc:2 * M_loc], seg[2 * M_loc:]
        v_left, v_mid, v_right = (
            valid[:M_loc], valid[M_loc:2 * M_loc], valid[2 * M_loc:]
        )
        # segment for dest s-1 travels LEFT; segment for dest s+1 RIGHT.
        perm_l = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        perm_r = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        from_right = jax.lax.ppermute(left, axis_name, perm_l)   # arrives at s-1
        vf_right = jax.lax.ppermute(v_left, axis_name, perm_l)
        from_left = jax.lax.ppermute(right, axis_name, perm_r)   # arrives at s+1
        vf_left = jax.lax.ppermute(v_right, axis_name, perm_r)
        out = (
            jnp.where(v_mid[:, None], mid, 0.0)
            + jnp.where(vf_right[:, None], from_right, 0.0)
            + jnp.where(vf_left[:, None], from_left, 0.0)
        )
        return out

    def fallback(_):
        """Ring-rotation exchange for arbitrary weight skew: rotate each
        shard's (particles, slot boundaries) one neighbor per hop and let
        every destination pull the output slots the visiting segment
        owns.  Worst case S-1 hops of [M_loc, nx] ppermutes — bandwidth-
        equal to an all-gather but with O(M_loc) peak memory (no
        [N, nx] replicated block, the thing that died at N ≈ 1e6) and
        M_loc-sized counting sorts instead of one O(N) serializing
        scatter; a psum'd coverage flag exits the loop as soon as every
        slot is served (2-3 hops under mild skew)."""
        s0 = shard * M_loc
        g = s0 + jnp.arange(M_loc, dtype=jnp.int32)
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

        def body(carry):
            out, covered, xq, Kq, baseq, h, done = carry
            # owner(g) = #{i : K_i <= g} within MY slot range, via the
            # counting-sort histogram (no searchsorted)
            Kw = jnp.clip(Kq - s0, 0, M_loc)
            hist = jnp.zeros((M_loc + 1,), jnp.int32).at[Kw].add(1)
            j = jnp.clip(jnp.cumsum(hist)[:-1], 0, M_loc - 1)
            valid = ((g >= baseq[0]) & (g < Kq[-1])
                     & jnp.logical_not(covered))
            out = out + jnp.where(valid[:, None], xq[j], 0.0)
            covered = covered | valid
            xq = jax.lax.ppermute(xq, axis_name, perm)
            Kq = jax.lax.ppermute(Kq, axis_name, perm)
            baseq = jax.lax.ppermute(baseq, axis_name, perm)
            ndone = jax.lax.psum(jnp.all(covered).astype(jnp.int32),
                                 axis_name)
            return (out, covered, xq, Kq, baseq, h + 1,
                    ndone >= n_shards)

        def cond(carry):
            *_, h, done = carry
            return (h < n_shards) & jnp.logical_not(done)

        out, covered, *_ = jax.lax.while_loop(
            cond, body,
            (jnp.zeros_like(state.x),
             jnp.zeros((M_loc,), bool),
             state.x, K, K_base.reshape(1), jnp.int32(0),
             jnp.asarray(False)))
        return out

    x_res = jax.lax.cond(overflow, fallback, distributed, operand=None)
    x_out = jnp.where(do, x_res, state.x)
    w0, we0 = _uniform_weights(M_loc, state.w.dtype)
    lNratio = jnp.log(jnp.asarray(n_shards, state.w.dtype))
    w = jnp.where(do, w0 - lNratio, state.w)
    we = jnp.where(do, we0 / n_shards, state.we)
    return x_out, w, we, key


def _predict_local(pf, state, u, p, t, axis_name, distributed_resample=True):
    """Per-shard propagation after global resampling."""
    if distributed_resample:
        x, w, we, key = _resample_distributed(state, pf, axis_name)
    else:
        x, w, we, key = _resample_global(state, pf, axis_name)
    shard = jax.lax.axis_index(axis_name)
    M_loc = x.shape[0]
    key, kn = jax.random.split(key)
    kn = jax.random.fold_in(kn, shard)  # decorrelate noise across shards
    if hasattr(pf, "measurement_likelihood"):  # AdvancedParticleFilter
        keys = jax.random.split(kn, M_loc)
        xn = jax.vmap(lambda xi, ki: pf.dynamics(xi, u, p, t, ki))(x, keys)
    else:
        xn = jax.vmap(lambda xi: pf.dynamics(xi, u, p, t))(x)
        if pf.dynamics_density is not None:
            xn = xn + pf.dynamics_density.sample(kn, (M_loc,))
    return PFState(x=xn, w=w, we=we, t=state.t + 1, key=key)


def sharded_update(pf, state: PFState, u, y, p=None, t=None,
                   mesh: Mesh = None, axis_name: str = "particles"):
    """One correct+predict PF step under `shard_map` over the particle axis.

    ``state`` must be sharded via :func:`shard_pf_state` (x/w/we split on
    the leading axis, t/key replicated).
    """
    p = pf.p if p is None else p

    st_spec = PFState(x=P(axis_name, None), w=P(axis_name), we=P(axis_name),
                      t=P(), key=P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(st_spec, P(), P()),
        out_specs=(
            st_spec,
            PFInfo(ll=P(), e=P()),
            (P(axis_name, None), P(axis_name), P(axis_name)),
        ),
        check_vma=False,
    )
    def step(st, u_, y_):
        tk = st.t * pf.Ts if t is None else t
        st, info = _correct_local(pf, st, u_, y_, p, tk, axis_name)
        filt = (st.x, st.w, st.we)  # filtered snapshot (post-correct)
        st2 = _predict_local(pf, st, u_, p, tk, axis_name)
        return st2, info, filt

    u = jnp.zeros((0,), dtype=state.x.dtype) if u is None else jnp.asarray(u)
    return step(state, u, jnp.asarray(y))


def sharded_forward_trajectory(pf, u, y, key, mesh: Mesh,
                               axis_name: str = "particles", p=None):
    """Mesh-sharded PF batch filtering: `lax.scan` of :func:`sharded_update`
    with per-step log-likelihood accumulation.  Returns ``(xs, ws, wes, ll)``
    with the particle axes left sharded."""
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = jnp.zeros((T, 0), dtype=y.dtype) if u is None else jnp.asarray(u)
    p = pf.p if p is None else p

    state0 = shard_pf_state(pf.init(key), mesh, axis_name)

    @jax.jit
    def run(state0, u_seq, y):
        def body(st, inp):
            uk, yk = inp
            st, info, (xf, wf, wef) = sharded_update(
                pf, st, uk, yk, p=p, mesh=mesh, axis_name=axis_name
            )
            return st, (info.ll, xf, wf, wef)

        st, (lls, xs, ws, wes) = jax.lax.scan(body, state0, (u_seq, y))
        return xs, ws, wes, jnp.sum(lls)

    return run(state0, u_seq, y)


# ---------------------------------------------------------------------------
# Mesh-sharded EnKF — the ensemble axis distributes like particles
# ---------------------------------------------------------------------------


def shard_enkf_state(state, mesh: Mesh, axis_name: str = "particles"):
    """Place an EnKFState with members sharded over ``axis_name``."""
    from ..filters.enkf import EnKFState

    return EnKFState(
        X=jax.device_put(state.X, NamedSharding(mesh, P(axis_name, None))),
        t=jax.device_put(state.t, NamedSharding(mesh, P())),
        key=jax.device_put(state.key, NamedSharding(mesh, P())),
    )


def sharded_enkf_update(enkf, state, u, y, p=None, t=None,
                        mesh: Mesh = None, axis_name: str = "particles"):
    """One stochastic-EnKF correct+predict step under `shard_map`.

    Member propagation and measurement evaluation are local; the ensemble
    statistics are `psum`s of per-shard moment contributions (the anomaly
    products ``XaᵀYa`` / ``YaᵀYa`` reduce over the member axis, so each
    shard contributes an [nx, ny]-sized partial — tiny interconnect traffic
    regardless of ensemble size).
    """
    from ..filters.enkf import EnKFState
    from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
    from ..ops.mvnormal import as_mvnormal
    from ..ops.matrices import resolve_mat

    p = enkf.p if p is None else p
    N = enkf.N

    st_spec = EnKFState(X=P(axis_name, None), t=P(), key=P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(st_spec, P(), P()),
        out_specs=(st_spec, P()),
        check_vma=False,
    )
    def step(st, u_, y_):
        shard = jax.lax.axis_index(axis_name)
        tk = st.t * enkf.Ts if t is None else t
        X = st.X  # [N_loc, nx]
        N_loc = X.shape[0]
        xbar = jax.lax.pmean(jnp.mean(X, axis=0), axis_name)
        R2 = resolve_mat(enkf.R2, xbar, u_, p, tk, Ts=enkf.Ts)
        R1 = resolve_mat(enkf.R1, xbar, u_, p, tk, Ts=enkf.Ts)

        # ---- correct (enkf.jl:279-356, distributed moments) -----------
        h = enkf.measurement
        Y = jax.vmap(lambda xi: h(xi, u_, p, tk))(X)
        ybar = jax.lax.pmean(jnp.mean(Y, axis=0), axis_name)
        Xa = X - xbar
        Ya = Y - ybar
        S = jax.lax.psum(Ya.T @ Ya, axis_name) / (N - 1)
        S = symmetrize(S) + R2
        Rxy = jax.lax.psum(Xa.T @ Ya, axis_name) / (N - 1)
        Schol = chol_lower(S)
        K = rdiv_chol(Rxy, Schol)
        key, ke = jax.random.split(st.key)
        eps = as_mvnormal(R2).sample(jax.random.fold_in(ke, shard), (N_loc,))
        Xn = X + (y_ + eps - Y) @ K.T

        # ---- predict (enkf.jl:228-269) ---------------------------------
        key, kw = jax.random.split(key)
        f = enkf.dynamics
        Xp = jax.vmap(lambda xi: f(xi, u_, p, tk))(Xn)
        Xp = Xp + as_mvnormal(R1).sample(jax.random.fold_in(kw, shard), (N_loc,))
        m = jax.lax.pmean(jnp.mean(Xp, axis=0), axis_name)
        Xp = m + enkf.inflation * (Xp - m)

        from ..ops.mvnormal import mvnormal_logpdf

        ll = mvnormal_logpdf(y_ - ybar, jnp.zeros_like(y_), Schol)
        return EnKFState(X=Xp, t=st.t + 1, key=key), ll

    u_arr = jnp.zeros((0,), dtype=state.X.dtype) if u is None else jnp.asarray(u)
    return step(state, u_arr, jnp.asarray(y))


# ---------------------------------------------------------------------------
# Mesh-sharded auxiliary particle filter
# ---------------------------------------------------------------------------


def sharded_apf_update(apf, state: PFState, u, y, y1=None, p=None, t=None,
                       mesh: Mesh = None, axis_name: str = "particles"):
    """One auxiliary-PF step (correct + lookahead predict) under
    `shard_map` over the particle axis.

    Mirrors ``AuxiliaryParticleFilter.update`` (filtering.jl:187-234):
    normalization-only correct, first-stage weights λ at noiselessly
    propagated particles, unconditional systematic resampling on the
    combined weights (O(N/devices) distributed exchange), and the
    reference's unresampled-λ second-stage weights.  ``y1`` is the next
    measurement; ``y1=None`` performs the plain correct only (last step).
    """
    inner = apf.pf
    p = inner.p if p is None else p
    from ..filters.particle import AdvancedParticleFilter

    advanced = isinstance(inner, AdvancedParticleFilter)
    st_spec = PFState(x=P(axis_name, None), w=P(axis_name), we=P(axis_name),
                      t=P(), key=P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(st_spec, P(), P(), P()),
        out_specs=(st_spec, PFInfo(ll=P(), e=P())),
        check_vma=False,
    )
    def step(st, u_, y_, y1_):
        tk = st.t * inner.Ts if t is None else t
        shard = jax.lax.axis_index(axis_name)
        S = jax.lax.axis_size(axis_name)
        M_loc = st.x.shape[0]
        N = M_loc * S

        # ---- correct: distributed normalization (filtering.jl:170-174)
        offset = jax.lax.pmax(jnp.max(st.w), axis_name)
        we = jnp.exp(st.w - offset)
        s = jax.lax.psum(jnp.sum(we), axis_name)
        ll = jnp.log(s) + offset
        st = st.replace(w=st.w - offset - jnp.log(s), we=we / s)
        info = PFInfo(ll=ll, e=jnp.zeros_like(y_))
        if y1_ is None:
            return st, info

        # ---- predict w/ lookahead (filtering.jl:195-234) -------------
        if advanced:
            xpred = jax.vmap(
                lambda xi: inner.dynamics(xi, u_, p, tk, None))(st.x)
            lam = jax.vmap(
                lambda xi: inner.measurement_likelihood(xi, u_, y1_, p,
                                                        tk))(xpred)
            x_first = st.x        # Advanced resamples the CURRENT cloud
        else:
            f, g, dg = (inner.dynamics, inner.measurement,
                        inner.measurement_density)
            xpred = jax.vmap(lambda xi: f(xi, u_, p, tk))(st.x)
            lam = dg.logpdf(
                y1_ - jax.vmap(lambda xi: g(xi, u_, p, tk))(xpred))
            x_first = xpred       # plain variant resamples the prediction

        wb = st.w + lam
        off_b = jax.lax.pmax(jnp.max(wb), axis_name)
        web = jnp.exp(wb - off_b)
        web = web / jax.lax.psum(jnp.sum(web), axis_name)
        tmp = st.replace(x=x_first, w=wb, we=web)
        x, _, _, key = _resample_distributed(tmp, inner, axis_name,
                                             force_resample=True)

        if advanced:
            key, kn = jax.random.split(key)
            keys = jax.random.split(jax.random.fold_in(kn, shard), M_loc)
            xn = jax.vmap(
                lambda xi, ki: inner.dynamics(xi, u_, p, tk, ki))(x, keys)
            w0, we0 = _uniform_weights(M_loc, st.w.dtype)
            return PFState(x=xn, w=w0 - jnp.log(jnp.asarray(S, st.w.dtype)),
                           we=we0 / S, t=st.t + 1, key=key), info

        if inner.dynamics_density is not None:
            key, kn = jax.random.split(key)
            x = x + inner.dynamics_density.sample(
                jax.random.fold_in(kn, shard), (M_loc,))
        # keep the UNRESAMPLED λ (filtering.jl:210-212)
        w_new = lam - jnp.log(jnp.asarray(N, st.w.dtype))
        off2 = jax.lax.pmax(jnp.max(w_new), axis_name)
        we_new = jnp.exp(w_new - off2)
        we_new = we_new / jax.lax.psum(jnp.sum(we_new), axis_name)
        return PFState(x=x, w=w_new, we=we_new, t=st.t + 1, key=key), info

    u_arr = jnp.zeros((0,), dtype=state.x.dtype) if u is None else jnp.asarray(u)
    if y1 is None:
        # last-step form: plain correct (shard_map specs need a concrete y1)
        y1_arr = None
    else:
        y1_arr = jnp.asarray(y1)
    if y1_arr is None:
        @partial(jax.shard_map, mesh=mesh, in_specs=(st_spec, P(), P()),
                 out_specs=(st_spec, PFInfo(ll=P(), e=P())), check_vma=False)
        def correct_only(st, u_, y_):
            offset = jax.lax.pmax(jnp.max(st.w), axis_name)
            we = jnp.exp(st.w - offset)
            s = jax.lax.psum(jnp.sum(we), axis_name)
            ll = jnp.log(s) + offset
            return (st.replace(w=st.w - offset - jnp.log(s), we=we / s),
                    PFInfo(ll=ll, e=jnp.zeros_like(y_)))

        return correct_only(state, u_arr, jnp.asarray(y))
    return step(state, u_arr, jnp.asarray(y), y1_arr)


# ---------------------------------------------------------------------------
# Mesh-sharded FFBS particle smoother
# ---------------------------------------------------------------------------


def sharded_ffbs_smooth(pf, u, y, M: int, key, mesh: Mesh,
                        axis_name: str = "particles", p=None):
    """FFBS backward simulation with the FORWARD cloud's particle axis
    sharded over the mesh (smoothing.jl:104-143 counterpart).

    Forward: :func:`sharded_forward_trajectory` (particle axis stays
    sharded).  Backward, per step and per backward trajectory m: each
    shard evaluates the backward weights ``wf + log N(xb | f(xf), R1)``
    against its local cloud only, draws a LOCAL Gumbel-max champion, and
    the global categorical winner is the `pmax` of the per-shard champion
    scores (Gumbel-max is exact under max-decomposition, so this is a
    draw from the full categorical with only [M]-sized collectives —
    weights psum-normalized implicitly by the shared max).

    Returns ``(xb [T, M, nx] replicated, ll)``.
    """
    from ..ops.mvnormal import as_mvnormal

    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = jnp.zeros((T, 0), dtype=y.dtype) if u is None else jnp.asarray(u)
    p = pf.p if p is None else p
    df = as_mvnormal(pf.dynamics_density)
    nx = df.mean.shape[-1]
    Linv = jax.scipy.linalg.solve_triangular(
        df.chol(), jnp.eye(nx, dtype=y.dtype), lower=True)
    mu = df.mean

    kf_, kb_ = jax.random.split(jax.random.fold_in(key, 1))
    xs, ws, wes, ll = sharded_forward_trajectory(
        pf, u_seq, y, kf_, mesh, axis_name, p=p)

    f = pf.dynamics
    tvec = jnp.arange(T) * pf.Ts

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, axis_name, None), P(None, axis_name), P(), P(),
                  P()),
        out_specs=P(),
        check_vma=False,
    )
    def backward(xf, wf, u_all, t_all, kb):
        shard = jax.lax.axis_index(axis_name)
        S = jax.lax.axis_size(axis_name)
        N_loc = xf.shape[1]

        def select_global(score, cand):
            """Exact global Gumbel-max winner from per-shard champions."""
            gmax = jax.lax.pmax(score, axis_name)              # [M]
            winner = jnp.where(score >= gmax, shard, S)
            wmin = jax.lax.pmin(winner, axis_name)
            is_win = (winner == wmin) & (score >= gmax)
            return jax.lax.psum(
                jnp.where(is_win[:, None], cand, 0.0), axis_name)

        def gumbel(k, shape):
            return -jnp.log(-jnp.log(
                jax.random.uniform(k, shape, dtype=y.dtype,
                                   minval=jnp.finfo(y.dtype).tiny)))

        # terminal draw: M categorical samples from we_T (smoothing.jl:118)
        kb, kt = jax.random.split(kb)
        gT = gumbel(jax.random.fold_in(kt, shard), (M, N_loc))
        scT = wf[-1][None, :] + gT
        amT = jnp.argmax(scT, axis=1)
        xb_T = select_global(
            jnp.take_along_axis(scT, amT[:, None], 1)[:, 0], xf[-1][amT])

        def backstep(carry, inp):
            xb, k = carry
            xf_t, wf_t, u_t, t_t = inp
            xpred = jax.vmap(lambda xi: f(xi, u_t, p, t_t))(xf_t)
            zp = xpred @ Linv.T                                # [N_loc, nx]
            zb = (xb - mu) @ Linv.T                            # [M, nx]
            wb = (wf_t[None, :] - 0.5 * jnp.sum(zp * zp, -1)[None, :]
                  + zb @ zp.T - 0.5 * jnp.sum(zb * zb, -1)[:, None])
            k, kg = jax.random.split(k)
            score = wb + gumbel(jax.random.fold_in(kg, shard), (M, N_loc))
            am = jnp.argmax(score, axis=1)
            xb_new = select_global(
                jnp.take_along_axis(score, am[:, None], 1)[:, 0], xf_t[am])
            return (xb_new, k), xb_new

        (_, _), xb_rest = jax.lax.scan(
            backstep, (xb_T, kb),
            (xf[:-1], wf[:-1], u_all[:-1], t_all[:-1]), reverse=True)
        return jnp.concatenate([xb_rest, xb_T[None]], axis=0)

    xb = backward(xs, ws, u_seq, tvec, kb_)
    return xb, ll


# ---------------------------------------------------------------------------
# Segmented mesh PF: each device advances its sub-cloud through a
# resampling-free segment with zero collectives.  Between segments the
# weights are globally normalized (pmax+psum) and the Neff-gated
# distributed exchange resamples the cloud — the estimator is a bootstrap
# PF whose resampling trigger is checked every `segment` steps instead of
# every step (any resampling schedule yields a valid/unbiased likelihood
# estimator; the per-step ll telescopes between resampling events, so
# segment log-likelihoods are exact: Σ_t ll_t = lse(w_end) − lse(w_start)).
# ---------------------------------------------------------------------------


def pf_segment(pf, u, y, seed, x0, w0):
    """One resampling-free PF segment on a local sub-cloud — the per-
    device body of :func:`sharded_pf_loglik_fused`.

    Runs ``T`` correct/predict steps of the bootstrap recursion on
    ``x0 [Nloc, nx]`` starting from log-weights ``w0 [Nloc]``, with NO
    resampling and NO global normalization — those happen at segment
    boundaries with cross-device collectives.  Per step the weights are
    normalized *locally* for f32 stability and the subtracted constants
    accumulate into ``ll_local``, so the unnormalized carried weights are
    recoverable as ``w_fin + ll_local`` (smoothing.jl:227-230 algebra).

    Returns ``(ll_local, x_fin [Nloc, nx], w_fin [Nloc])``.
    """
    x0 = jnp.asarray(x0, jnp.float32)
    w0 = jnp.asarray(w0, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    T = y.shape[0]
    Nloc = x0.shape[0]
    p = pf.p
    Ts = float(pf.Ts)
    u_seq = (jnp.zeros((T, 0), jnp.float32) if u is None
             else jnp.broadcast_to(jnp.asarray(u, jnp.float32),
                                   (T,) + jnp.shape(u)[1:]))
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    keys = jax.random.split(key, T)
    tvec = jnp.arange(T, dtype=jnp.float32) * Ts

    g = pf.measurement
    f = pf.dynamics
    dmeas = pf.measurement_density
    ddyn = pf.dynamics_density

    def step(carry, inp):
        x, w, ll = carry
        uk, yk, tk, kk = inp
        yh = jax.vmap(lambda xi: g(xi, uk, p, tk))(x)
        logp = jax.vmap(dmeas.logpdf)(yk[None, :] - yh)
        missing = jnp.any(jnp.isnan(yk))
        w1 = w + jnp.where(missing, 0.0, logp)
        m = jnp.max(w1)
        lse = m + jnp.log(jnp.sum(jnp.exp(w1 - m)))
        ll_t = jnp.where(missing, 0.0, lse)
        w2 = w1 - ll_t  # subtract exactly the ll contribution
        xn = jax.vmap(lambda xi: f(xi, uk, p, tk))(x)
        xn = xn + ddyn.sample(kk, (Nloc,)).astype(xn.dtype)
        return (xn, w2, ll + ll_t), None

    (x_fin, w_fin, ll), _ = jax.lax.scan(
        step, (x0, w0, jnp.float32(0.0)), (u_seq, y, tvec, keys))
    return ll, x_fin, w_fin


def sharded_pf_loglik_fused(pf, u, y, key, mesh: Mesh,
                            axis_name: str = "particles",
                            segment: int = 32, p=None):
    """Bootstrap-PF log-likelihood with the cloud sharded over ``mesh``,
    each device running :func:`pf_segment` on its resident sub-cloud.

    Composition per segment of ``segment`` steps:

    1. each device advances its [N/D, nx] sub-cloud — propagate/weight/
       locally-normalize, NO resampling, zero collectives,
    2. one `pmax` + one `psum` turn the locally-accumulated lls and
       carried weights into the global segment log-likelihood
       (telescoped lse difference) and globally-normalized weights,
    3. the global-Neff-gated O(N/D) distributed exchange
       (:func:`_resample_distributed`) resamples across devices.

    Returns the total ``ll``.

    ``segment`` trades boundary cost (the exchange) against estimator
    quality: the likelihood estimate stays unbiased for ANY resampling
    schedule, but its variance (and the log-domain Jensen bias) grows
    with the resample-free span — on the 2-state benchmark model at
    N=16384, segment 8/32 land within 0.6% of the exact KF loglik while
    segment≈T (never resampling) was 45% low.  Keep segments ≈ a few
    tens of steps unless the weights are known to degenerate slowly.
    """
    n_dev = mesh.devices.size
    if pf.N % n_dev:
        raise ValueError(f"N={pf.N} not divisible by {n_dev} devices")
    y = jnp.asarray(y, jnp.float32)
    T = y.shape[0]
    nseg = -(-T // segment)
    Tpad = nseg * segment
    # pad with NaN measurements: the segment's missing-measurement skip
    # (PFtypes.jl:109) makes padded steps ll-neutral
    ypad = jnp.concatenate(
        [y, jnp.full((Tpad - T, y.shape[1]), jnp.nan, jnp.float32)], 0)
    if u is None:
        upad = None
    else:
        u_arr = jnp.asarray(u, jnp.float32)
        upad = jnp.concatenate(
            [u_arr, jnp.zeros((Tpad - T,) + u_arr.shape[1:], jnp.float32)],
            0)
    M_loc = pf.N // n_dev
    base_seed = jax.random.bits(key, (), jnp.uint32).astype(jnp.int32)
    k_init, k_r = jax.random.split(key)

    def local(ypad, upad):
        shard = jax.lax.axis_index(axis_name)
        kd = jax.random.fold_in(k_init, shard)
        x0 = pf.initial_density.sample(kd, (M_loc,)).astype(jnp.float32)
        w0 = jnp.full((M_loc,), -jnp.log(jnp.float32(pf.N)))
        # segment loop as lax.scan: one segment body in the jaxpr
        # regardless of nseg — a Python loop would inline one body per
        # segment and make compile time grow with T
        y_segs = ypad.reshape(nseg, segment, ypad.shape[-1])
        u_segs = (None if upad is None
                  else upad.reshape(nseg, segment, *upad.shape[1:]))

        def seg_step(carry, inp):
            x, w, ll_tot, kr = carry
            if u_segs is None:
                s, y_seg = inp
                u_seg = None
            else:
                s, y_seg, u_seg = inp
            seed_s = base_seed + 7919 * (
                shard.astype(jnp.int32) * nseg + s)
            ll_loc, x, w_loc = pf_segment(pf, u_seg, y_seg, seed_s, x, w)
            # global lse of the carried unnormalized weights
            w_un = w_loc + ll_loc
            m_g = jax.lax.pmax(jnp.max(w_un), axis_name)
            s_g = jax.lax.psum(jnp.sum(jnp.exp(w_un - m_g)), axis_name)
            lse_g = m_g + jnp.log(s_g)
            ll_tot = ll_tot + lse_g
            w = w_un - lse_g                       # globally normalized
            # Neff-gated exchange every segment (including the last: ll
            # is already accumulated, so the final exchange is inert —
            # cheaper than a collective-bearing cond on s < nseg-1)
            we = jnp.exp(w)
            st = PFState(x=x, w=w, we=we, t=s, key=kr)
            x, w, we, kr = _resample_distributed(st, pf, axis_name)
            return (x, w, ll_tot, kr), None

        # resample key: IDENTICAL across shards (shared r draw)
        xs = (jnp.arange(nseg, dtype=jnp.int32), y_segs)
        if u_segs is not None:
            xs = xs + (u_segs,)
        (_, _, ll_tot, _), _ = jax.lax.scan(
            seg_step, (x0, w0, jnp.float32(0.0), k_r), xs)
        return ll_tot

    # check_vma=False: the segment scan's weight/ll carries start as
    # replicated constants and become device-varying after the first
    # step — semantically fine, but the static vma checker rejects it
    if upad is None:
        fn = jax.shard_map(lambda yy: local(yy, None), mesh=mesh,
                           in_specs=(P(),), out_specs=P(),
                           check_vma=False)
        return fn(ypad)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(), check_vma=False)
    return fn(ypad, upad)


# ---------------------------------------------------------------------------
# Time-axis-sharded associative filter scan: each device runs the
# associative scan on its LOCAL time block (the inner Blelloch level),
# then one all_gather of D carry elements + a tiny replicated prefix
# combine (the outer Blelloch level, over the device interconnect) folds
# the cross-device carries in.
# ---------------------------------------------------------------------------


def sharded_filter_scan(A, b, C, eta, J, axis_name: str = "time"):
    """Per-device body: inclusive prefix scan of the associative Kalman
    filtering elements sharded along the time axis (call under
    `shard_map` with all element stacks split on ``axis_name``).

    Local level: `jax.lax.associative_scan` over the local block.
    Outer level: all_gather of each device's LAST combined element
    (5 small matrices — O(D·nx²) bytes between devices), an exclusive
    prefix combine of the D carries replicated on every device (D is
    tiny), and one vectorized combine folding the incoming carry into
    every local prefix.  Returns the globally-combined
    ``(A, b, C, eta, J)`` local blocks; ``b``/``C`` are the filtered
    mean/covariance.
    """
    from .temporal import _filter_combine

    nx = b.shape[-1]
    loc = jax.lax.associative_scan(_filter_combine, (A, b, C, eta, J))
    last = tuple(e[-1] for e in loc)
    gathered = tuple(
        jax.lax.all_gather(e, axis_name) for e in last)  # [D, ...] each
    D = gathered[0].shape[0]
    # exclusive prefix of the D carries, replicated tiny compute
    ident = (jnp.eye(nx, dtype=b.dtype), jnp.zeros((nx,), b.dtype),
             jnp.zeros((nx, nx), b.dtype), jnp.zeros((nx,), b.dtype),
             jnp.zeros((nx, nx), b.dtype))
    acc = ident
    prefixes = []
    for d in range(D):
        prefixes.append(acc)
        acc = _filter_combine(acc, tuple(g[d] for g in gathered))
    pref = tuple(jnp.stack([pr[i] for pr in prefixes])
                 for i in range(5))  # [D, ...]
    shard = jax.lax.axis_index(axis_name)
    mine = tuple(jax.lax.dynamic_index_in_dim(pr, shard, 0, keepdims=False)
                 for pr in pref)
    return jax.vmap(lambda *e: _filter_combine(mine, tuple(e)))(*loc)


def _halo_prev(x_loc, axis_name):
    """Shift a local [Tl, ...] block down by one step, filling index 0
    with the LAST row of the previous device (one `ppermute` hop between
    neighbouring devices).  Device 0's index 0 receives zeros — callers mask it with the
    prior anyway (the global t=0 special case)."""
    D = jax.lax.axis_size(axis_name)
    if D == 1:
        prev_last = jnp.zeros_like(x_loc[-1])
    else:
        prev_last = jax.lax.ppermute(
            x_loc[-1], axis_name, [(d, d + 1) for d in range(D - 1)])
    return jnp.concatenate([prev_last[None], x_loc[:-1]], axis=0)


def _time_sharded_filter_local(F, c, H, Q, R, y_eff, *, m0, P0, axis_name):
    """Per-device Kalman-filter body: LOCAL associative-element
    construction (building all O(T·nx²) elements before the shard_map
    would not scale per device), the two-level Blelloch scan (:func:`sharded_filter_scan`), and the local ll
    epilogue.  All array inputs are local [T/D, ...] blocks; peak
    per-device memory is O(T/D · nx²)."""
    from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
    from ..ops.mvnormal import mvnormal_logpdf_cov

    nx = m0.shape[-1]
    Tl = y_eff.shape[0]
    shard = jax.lax.axis_index(axis_name)
    first = (shard * Tl + jnp.arange(Tl)) == 0
    eye = jnp.eye(nx, dtype=c.dtype)
    # the transition entering element k is the one resolved at k-1
    # (correct-then-predict convention, temporal._filter_elements)
    Fp, cp, Qp = (_halo_prev(F, axis_name), _halo_prev(c, axis_name),
                  _halo_prev(Q, axis_name))

    def generic(Fk, ck, Hk, Qk, Rk, yk):
        S = symmetrize(Hk @ Qk @ Hk.T) + Rk
        Sch = chol_lower(S)
        K = rdiv_chol(Qk @ Hk.T, Sch)
        A = (eye - K @ Hk) @ Fk
        b = ck + K @ (yk - Hk @ ck)
        C = symmetrize((eye - K @ Hk) @ Qk)
        HtSinv = rdiv_chol(Hk.T, Sch)
        eta = Fk.T @ HtSinv @ (yk - Hk @ ck)
        J = symmetrize(Fk.T @ HtSinv @ Hk @ Fk)
        return A, b, C, eta, J

    A, b, C, eta, J = jax.vmap(generic)(Fp, cp, H, Qp, R, y_eff)
    # global element 0: measurement update of the PRIOR (computed with
    # this device's local head matrices — only device 0's mask selects it)
    S0 = symmetrize(H[0] @ P0 @ H[0].T) + R[0]
    K0 = rdiv_chol(P0 @ H[0].T, chol_lower(S0))
    b0 = m0 + K0 @ (y_eff[0] - H[0] @ m0)
    C0 = symmetrize((eye - K0 @ H[0]) @ P0)
    mM, mV = first[:, None, None], first[:, None]
    A = jnp.where(mM, 0.0, A)
    b = jnp.where(mV, b0[None], b)
    C = jnp.where(mM, C0[None], C)
    eta = jnp.where(mV, 0.0, eta)
    J = jnp.where(mM, 0.0, J)

    _, xt, Rt, _, _ = sharded_filter_scan(A, b, C, eta, J,
                                          axis_name=axis_name)

    # ll epilogue: predicted moments from the shifted filtered moments
    # (one more ppermute halo), local innovation densities, one psum
    xtp, Rtp = _halo_prev(xt, axis_name), _halo_prev(Rt, axis_name)
    x_pred = jnp.einsum("tij,tj->ti", Fp, xtp) + cp
    R_pred = jnp.einsum("tij,tjk,tlk->til", Fp, Rtp, Fp) + Qp
    x_pred = jnp.where(mV, m0[None], x_pred)
    R_pred = jnp.where(mM, P0[None], R_pred)
    S = jnp.einsum("tij,tjk,tlk->til", H, R_pred, H) + R
    e = y_eff - jnp.einsum("tij,tj->ti", H, x_pred)
    lls = jax.vmap(lambda ek, Sk: mvnormal_logpdf_cov(
        ek, jnp.zeros_like(ek), Sk))(e, S)
    ll = jax.lax.psum(jnp.sum(lls), axis_name)
    return xt, Rt, ll


def _resolve_time_seqs(kf, u, y, p):
    """Resolve the six get_mat specs into [T, ...] sequences plus the
    effective drive/measurement (shared by the time-sharded verbs).
    Constant matrices resolve to `broadcast_to` views, which XLA fuses
    into each device's shard — the global stack never materializes."""
    from .temporal import _resolve_seq

    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = jnp.zeros((T, 0), y.dtype) if u is None else jnp.asarray(u)
    p = kf.p if p is None else p
    Ts = getattr(kf, "Ts", 1.0)
    tvec = jnp.arange(T) * Ts
    m0, P0 = kf.d0.mean, kf.d0.cov
    nx = m0.shape[-1]

    F = _resolve_seq(kf.A, m0, u_seq, tvec, p, Ts)
    B = _resolve_seq(kf.B, m0, u_seq, tvec, p, Ts)
    H = _resolve_seq(kf.C, m0, u_seq, tvec, p, Ts)
    D_ = _resolve_seq(kf.D, m0, u_seq, tvec, p, Ts)
    Q = _resolve_seq(kf.R1, m0, u_seq, tvec, p, Ts)
    R = _resolve_seq(kf.R2, m0, u_seq, tvec, p, Ts)
    c = (jnp.einsum("tij,tj->ti", B, u_seq)
         if (B is not None and u_seq.shape[-1])
         else jnp.zeros((T, nx), y.dtype))
    y_eff = y - jnp.einsum("tij,tj->ti", D_, u_seq) if D_ is not None else y
    return F, c, H, Q, R, y_eff, m0, P0


def time_sharded_parallel_kf(kf, u, y, mesh: Mesh,
                             axis_name: str = "time", p=None):
    """O(log T) Kalman filtering with the TIME axis sharded over the mesh
    — the multi-chip extension of
    :func:`...parallel.temporal.parallel_forward_trajectory` for
    trajectories too long for one chip's HBM.  Element construction,
    the halo shifts, and the ll epilogue all run INSIDE the shard_map on
    local [T/D, ...] blocks (per-device peak memory O(T/D · nx²)).
    Returns ``(xt, Rt, ll)`` (filtered means/covariances sharded along
    time, and the replicated total log-likelihood; use the single-chip
    path for the full innovation solution)."""
    F, c, H, Q, R, y_eff, m0, P0 = _resolve_time_seqs(kf, u, y, p)
    fn = jax.shard_map(
        partial(_time_sharded_filter_local, m0=m0, P0=P0,
                axis_name=axis_name),
        mesh=mesh, in_specs=(P(axis_name),) * 6,
        out_specs=(P(axis_name), P(axis_name), P()), check_vma=False)
    return fn(F, c, H, Q, R, y_eff)


def _time_sharded_smooth_local(F, c, H, Q, R, y_eff, *, m0, P0, axis_name):
    """Per-device RTS body: runs the sharded filter locally, builds the
    LOCAL smoothing elements from the filtered moments, reverse-scans
    them, and folds the cross-device suffix carries (the reverse-
    direction outer Blelloch level: one all_gather of D elements between
    devices + a tiny replicated suffix combine)."""
    from .temporal import _smooth_combine

    xt, Rt, ll = _time_sharded_filter_local(
        F, c, H, Q, R, y_eff, m0=m0, P0=P0, axis_name=axis_name)
    from ..ops.linalg import symmetrize, chol_lower, rdiv_chol

    nx = m0.shape[-1]
    Tl = xt.shape[0]
    D = jax.lax.axis_size(axis_name)
    shard = jax.lax.axis_index(axis_name)
    glast = (shard * Tl + jnp.arange(Tl)) == (D * Tl - 1)

    # smoothing element k uses the step-k transition (k→k+1) — the
    # UNSHIFTED local F/c/Q (temporal._smooth_elements)
    def generic(Fk, ck, Qk, mk, Pk):
        Pp = symmetrize(Fk @ Pk @ Fk.T) + Qk
        E = rdiv_chol(Pk @ Fk.T, chol_lower(Pp))
        g = mk - E @ (Fk @ mk + ck)
        L = symmetrize(Pk - E @ Fk @ Pk)
        return E, g, L

    E, g, L = jax.vmap(generic)(F, c, Q, xt, Rt)
    # global terminal element: identity at the filtered terminal state
    mM, mV = glast[:, None, None], glast[:, None]
    E = jnp.where(mM, 0.0, E)
    g = jnp.where(mV, xt, g)
    L = jnp.where(mM, Rt, L)

    # local reverse inclusive scan (earlier element absorbs later)
    Ec, gc, Lc = jax.lax.associative_scan(
        lambda a, b: _smooth_combine(b, a), (E, g, L), reverse=True)

    # outer level: each device's FIRST combined element composes its
    # whole block; gather D of them, suffix-combine replicated, fold
    heads = (Ec[0], gc[0], Lc[0])
    gathered = tuple(jax.lax.all_gather(e, axis_name) for e in heads)
    ident = (jnp.eye(nx, dtype=g.dtype), jnp.zeros((nx,), g.dtype),
             jnp.zeros((nx, nx), g.dtype))
    acc = ident
    suffixes = [None] * D
    for d in reversed(range(D)):
        suffixes[d] = acc
        acc = _smooth_combine(tuple(e[d] for e in gathered), acc)
    suff = tuple(jnp.stack([s[i] for s in suffixes]) for i in range(3))
    mine = tuple(jax.lax.dynamic_index_in_dim(s, shard, 0, keepdims=False)
                 for s in suff)
    _, xT, RT = jax.vmap(
        lambda *e: _smooth_combine(tuple(e), mine))(Ec, gc, Lc)
    return xT, RT, xt, Rt, ll


def time_sharded_parallel_smooth(kf, u, y, mesh: Mesh,
                                 axis_name: str = "time", p=None):
    """O(log T) RTS smoothing with the TIME axis sharded over the mesh —
    the multi-chip `smooth(kf, …)` (smoothing.jl:10-33) for trajectories
    too long for one chip.  One shard_map runs the time-sharded filter
    AND the reverse smoothing scan on local blocks.
    Returns ``(xT, RT, xt, Rt, ll)``: smoothed and filtered moments
    sharded along time, plus the replicated total log-likelihood."""
    F, c, H, Q, R, y_eff, m0, P0 = _resolve_time_seqs(kf, u, y, p)
    fn = jax.shard_map(
        partial(_time_sharded_smooth_local, m0=m0, P0=P0,
                axis_name=axis_name),
        mesh=mesh, in_specs=(P(axis_name),) * 6,
        out_specs=(P(axis_name),) * 4 + (P(),), check_vma=False)
    return fn(F, c, H, Q, R, y_eff)
