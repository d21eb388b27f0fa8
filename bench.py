"""Throughput of the plain verbs on an accelerator — prints ONE JSON line.

Workloads follow the reference's published benchmarks
(docs/src/benchmark.md): the bootstrap PF on the 2-state linear-Gaussian
model at N=1e5 (resampling threshold 0.1 and 1.0) and N=1e6, KF banks of
1024 and 8192 shared-model filters, the 4-state constant-velocity UKF at
T=50k, the FFBS particle smoother, and the temporal-parallel KF/UKF
smoothers.  Each time is the median host-clock time of a compiled call
that ends in ``block_until_ready``; compilation is excluded.  BASELINE.md
holds the single-core Julia numbers the ``*_vs_julia`` fields divide by.

Run on the card: ``python bench.py``.  Without an accelerator it exits
non-zero; it never reports CPU times as device numbers.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from chip_smoke import _benchmark_kf, _cv_ukf

BASELINE_PF_PARTICLE_STEPS_PER_S = 7.37e6  # docs/src/benchmark.md:48
BASELINE_UKF_STEPS_PER_S = 50_000 / 0.01768  # docs/src/benchmark.md:158


def _timeit(fn, *args, repeats=3):
    """Median seconds of ``repeats`` synchronized calls (after a warm-up
    call that compiles)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def bench_pf(N=100_000, T=1_000, resample_threshold=0.1):
    """Bootstrap-PF particle-steps/s through ``llpf.loglik`` and the
    relative error against the exact KF loglik on the same data."""
    import lowlevelparticlefilters_jl_tpu as llpf

    kf, (A, B, C, R1, R2) = _benchmark_kf()
    pf = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: C @ x, dynamics_density=R1,
        measurement_density=R2, initial_density=R1,
        resample_threshold=resample_threshold)
    _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((T, 1), jnp.float32),
                              jax.random.PRNGKey(0))
    run = jax.jit(lambda u, y, k: llpf.loglik(pf, u, y, key=k))
    key = jax.random.PRNGKey(1)
    dt = _timeit(run, us, ys, key)
    ll = float(run(us, ys, key))
    ll_kf = float(jax.jit(lambda u, y: llpf.loglik(kf, u, y))(us, ys))
    return N * T / dt, abs(ll - ll_kf) / abs(ll_kf)


def bench_kf_bank(Bk=1024, T=200):
    """Shared-model KF bank (``kf_bank_loglik``) in filter passes/s, and
    its agreement with ``vmap(loglik)``."""
    import lowlevelparticlefilters_jl_tpu as llpf

    kf, _ = _benchmark_kf()
    us = 0.3 * jnp.ones((Bk, T, 1), jnp.float32)
    ys = jax.vmap(lambda k, u: llpf.simulate(kf, u, k)[2])(
        jax.random.split(jax.random.PRNGKey(0), Bk), us)
    run = jax.jit(lambda u, y: llpf.kf_bank_loglik(kf, u, y))
    dt = _timeit(run, us, ys)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda u, y: jax.vmap(
            lambda a, b: llpf.loglik(kf, a, b))(u, y))(us, ys)
    ll = run(us, ys)
    rel = float(jnp.max(jnp.abs(ll - ref) / jnp.abs(ref)))
    return Bk / dt, rel


def bench_ukf(T=50_000):
    """4-state CV UKF: sequential steps/s (``method="auto"``), the
    temporal-parallel reduction (``method="parallel"``), a vmapped bank
    of 1024 and the affine-routed ``ukf_bank_loglik`` of 8192."""
    import lowlevelparticlefilters_jl_tpu as llpf

    ukf = _cv_ukf()
    ys = jax.random.normal(jax.random.PRNGKey(0), (T, 2), jnp.float32)
    seq = _timeit(jax.jit(lambda y: llpf.loglik(ukf, None, y)), ys)
    par = _timeit(jax.jit(lambda y: llpf.loglik(ukf, None, y,
                                                method="parallel")), ys)
    ysb = jax.random.normal(jax.random.PRNGKey(1), (1024, 1000, 2),
                            jnp.float32)
    bank = _timeit(jax.jit(lambda y: jax.vmap(
        lambda a: llpf.loglik(ukf, None, a))(y)), ysb)
    ysa = jax.random.normal(jax.random.PRNGKey(2), (8192, 200, 2),
                            jnp.float32)
    aff = _timeit(jax.jit(lambda y: llpf.ukf_bank_loglik(ukf, None, y)), ysa)
    return T / seq, T / par, 1024 * 1000 / bank, 8192 * 200 / aff


def bench_ffbs(N=1000, M=1000, T=500):
    """FFBS particle smoother in backward weight evaluations/s (T·M·N)."""
    import lowlevelparticlefilters_jl_tpu as llpf

    kf, (A, B, C, R1, R2) = _benchmark_kf()
    pf = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: C @ x, dynamics_density=R1,
        measurement_density=R2, initial_density=R1)
    _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((T, 1), jnp.float32),
                              jax.random.PRNGKey(0))
    run = jax.jit(lambda k: pf.smooth(us, ys, M=M, key=k)[0].sum())
    return T * M * N / _timeit(run, jax.random.PRNGKey(3))


def bench_parallel_kf(T=100_000):
    """Sequential vs temporal-parallel KF ``forward_trajectory`` at T."""
    import lowlevelparticlefilters_jl_tpu as llpf

    kf, _ = _benchmark_kf()
    _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((T, 1), jnp.float32),
                              jax.random.PRNGKey(0))
    seq = _timeit(jax.jit(lambda u, y: llpf.forward_trajectory(
        kf, u, y, method="sequential").ll), us, ys)
    par = _timeit(jax.jit(lambda u, y: llpf.forward_trajectory(
        kf, u, y, method="parallel").ll), us, ys)
    return T / seq, T / par


def bench_parallel_ukf_smooth(T=50_000, nonlinear=False):
    """O(log T) iterated sigma-point smoother: the affine CV model (exact
    in one pass) or a quadtank-style square-root-outflow model (4
    iterations of the full unscented SLR)."""
    import lowlevelparticlefilters_jl_tpu as llpf

    if nonlinear:
        g1 = lambda x: jnp.sqrt(jnp.abs(x) + 0.1)
        ukf = llpf.make_ukf(
            lambda x, u, p, t: x + 0.1 * jnp.array(
                [-g1(x[0]) + 0.5 * g1(x[1]), -0.5 * g1(x[1]) + 0.1]),
            lambda x, u, p, t: x, 0.001 * jnp.eye(2, dtype=jnp.float32),
            0.01 * jnp.eye(2, dtype=jnp.float32), ny=2, nu=0,
            d0=llpf.MvNormal(jnp.ones(2, jnp.float32),
                             0.1 * jnp.eye(2, dtype=jnp.float32)))
        ys = 1.0 + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (T, 2),
                                           jnp.float32)
        iters = 4
    else:
        ukf = _cv_ukf()
        ys = jax.random.normal(jax.random.PRNGKey(0), (T, 2), jnp.float32)
        iters = 2
    run = jax.jit(lambda y: llpf.parallel_ukf_smooth(
        ukf, None, y, iters=iters).xT.sum())
    return T / _timeit(run, ys)


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    devs = jax.devices()
    if devs[0].platform == "cpu":
        print("bench.py: no accelerator found; refusing to report CPU times",
              file=sys.stderr)
        return 2
    from lowlevelparticlefilters_jl_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache(here)
    pf_rate, pf_err = bench_pf()
    pf_full_rate, pf_full_err = bench_pf(resample_threshold=1.0)
    pf_1m_rate, pf_1m_err = bench_pf(N=1_000_000, T=200)
    kf_rate, kf_err = bench_kf_bank()
    kf8_rate, kf8_err = bench_kf_bank(Bk=8192)
    ukf_rate, ukf_par_rate, ukf_bank_rate, ukf_aff_rate = bench_ukf()
    pkf_seq, pkf_par = bench_parallel_kf()
    out = {
        "metric": "bootstrap_pf_particle_steps_per_s_N1e5",
        "value": pf_rate,
        "unit": "particle-steps/s",
        "vs_baseline": pf_rate / BASELINE_PF_PARTICLE_STEPS_PER_S,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "extra": {
            "pf_ll_rel_err_vs_kf": pf_err,
            "pf_resample_every_step_steps_per_s": pf_full_rate,
            "pf_resample_every_step_ll_rel_err_vs_kf": pf_full_err,
            "pf_N1e6_steps_per_s": pf_1m_rate,
            "pf_N1e6_ll_rel_err_vs_kf": pf_1m_err,
            "kf_bank1024_passes_per_s": kf_rate,
            "kf_bank1024_ll_rel_err_vs_vmap": kf_err,
            "kf_bank8192_passes_per_s": kf8_rate,
            "kf_bank8192_ll_rel_err_vs_vmap": kf8_err,
            "ukf_steps_per_s_T50k": ukf_rate,
            "ukf_vs_julia_baseline": ukf_rate / BASELINE_UKF_STEPS_PER_S,
            "ukf_parallel_steps_per_s_T50k": ukf_par_rate,
            "ukf_bank1024_steps_per_s": ukf_bank_rate,
            "ukf_bank8192_affine_steps_per_s": ukf_aff_rate,
            "ffbs_weight_evals_per_s_MN1000_T500": bench_ffbs(),
            "ffbs_weight_evals_per_s_M1000_N65536": bench_ffbs(
                N=65536, M=1000, T=100),
            "kf_sequential_steps_per_s_T1e5": pkf_seq,
            "kf_parallel_steps_per_s_T1e5": pkf_par,
            "parallel_ukf_smooth_steps_per_s_T50k":
                bench_parallel_ukf_smooth(),
            "parallel_ukf_smooth_nonlinear_steps_per_s_it4":
                bench_parallel_ukf_smooth(nonlinear=True),
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
