#!/usr/bin/env python3
"""Smoke run of the estimation main path on a GPU.

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Each phase drives the library's public verbs (``import
lowlevelparticlefilters_jl_tpu as llpf``) at sizes users run, compares
the result with a plain reference — the exact Kalman-filter likelihood,
or the sequential f32 ``lax.scan`` traced under
``jax.default_matmul_precision("highest")`` — and prints one JSON line
with its sizes, compile and run seconds (host clock around work that
ends in ``block_until_ready``), the compared quantity, its tolerance,
the reference's precision and pass/fail.  The verbs themselves run at
default precision, as users get them.

A line with the card's name and power limit (``nvidia-smi``) comes
first.  The last line is ``{"ok": true, "device": {...}}`` when every
phase passed; otherwise ``{"ok": false, ...}`` and a non-zero exit.
Without a GPU the script exits non-zero before running anything.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Full sizes: the deployments each phase stands for.  Tests pass tiny ones.
FULL = {
    "pf": [(100_000, 1000, 0.1), (100_000, 1000, 1.0), (1_000_000, 200, 0.1)],
    "resample_N": 100_000,
    "kf_T": 100_000,
    "ukf_T": 50_000,
    "bank": (8192, 200),
    "grad_T": 10_000,
    "ffbs": (1000, 65536, 100),          # M, N, T
    # four-card sizes
    "mesh_pf": (4_000_000, 100),         # N (1e6 per card), T
    "mesh_enkf_N": 1_000_000,
    "mesh_bank": (32768, 200),
    "mesh_time_T": 400_000,
    "mesh_ffbs": (256, 262_144, 50),     # M, N, T
    "mesh_segment_pf": (4_000_000, 200, 8),  # N, T, segment
    # Monte-Carlo tolerances (~4.5 standard errors at these sizes; the
    # deterministic comparisons keep fixed tolerances below)
    "tol": {"pf": 1e-3, "mesh_pf": 1e-3, "segment_pf": 2e-3,
            "ffbs_z": 4.0, "enkf_z": 6.0},
}

HIGHEST = "f32, jax.default_matmul_precision('highest')"


# ---------------------------------------------------------------------------
# Device checks and reporting
# ---------------------------------------------------------------------------


def require_gpu(n_cards: int):
    """The JAX devices, or exit non-zero with the reason when fewer than
    ``n_cards`` GPUs are visible.  There is no CPU fallback."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no GPU found ({e})", file=sys.stderr)
        sys.exit(2)
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform is "
              f"{devs[0].platform!r})", file=sys.stderr)
        sys.exit(2)
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    return devs


def card_line(devs) -> str:
    """``nvidia-smi`` name and power limit of the cards (a child process
    that does not touch JAX), plus JAX's device kind and count."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        smi = " ; ".join(l.strip() for l in r.stdout.splitlines()
                         if l.strip()) or f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return (f"card: {smi} | device_kind={devs[0].device_kind} "
            f"| count={len(devs)}")


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _check(quantity: str, value: float, tol: float, ref: str) -> dict:
    ok = bool(math.isfinite(value) and value <= tol)
    return {"quantity": quantity, "value": value, "tol": tol,
            "ref_precision": ref, "pass": ok}


def _record(phase: str, sizes: dict, timings: dict, checks: list) -> dict:
    return {
        "phase": phase, "sizes": sizes,
        "compile_s": sum(t["compile_s"] for t in timings.values()),
        "run_s": sum(t["run_s"] for t in timings.values()),
        "timings": timings, "checks": checks,
        "pass": all(c["pass"] for c in checks),
    }


def timed(fn, *args, repeats: int = 2):
    """Compile ``fn`` for ``args`` and run it; returns ``(out, timing)``
    with the compile seconds and the fastest of ``repeats`` runs, each
    ended by ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return out, {"compile_s": compile_s, "run_s": min(runs)}


def reference(fn, *args):
    """``fn`` traced and run at highest matmul precision."""
    import jax

    with jax.default_matmul_precision("highest"):
        return jax.block_until_ready(jax.jit(fn)(*args))


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _maxabs_scaled(a, b) -> float:
    """max |a - b| over the state scale max(1, max |b|)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def peak_bytes(devs) -> list:
    out = []
    for d in devs:
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _benchmark_kf():
    """The 2-state benchmark system (reference docs/src/benchmark.md)."""
    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf
    from __graft_entry__ import _benchmark_system

    A, B, C, R1, R2 = _benchmark_system(jnp)
    return llpf.KalmanFilter(A, B, C, 0, R1, R2), (A, B, C, R1, R2)


def _benchmark_pf(N: int, thr: float):
    import lowlevelparticlefilters_jl_tpu as llpf

    _, (A, B, C, R1, R2) = _benchmark_kf()
    return llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: C @ x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1,
        resample_threshold=thr)


def _benchmark_data(T: int, seed: int = 0):
    import jax
    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf

    kf, _ = _benchmark_kf()
    _, u, y = llpf.simulate(kf, 0.3 * jnp.ones((T, 1), jnp.float32),
                            jax.random.PRNGKey(seed))
    return u, y


def _cv_ukf():
    """4-state/2-output constant-velocity UKF (reference
    docs/src/benchmark.md:120-158)."""
    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf

    dt = 0.1
    A = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0],
                   [0, 0, 0, 1]], jnp.float32)
    C = jnp.array([[1, 0, 0, 0], [0, 1, 0, 0]], jnp.float32)
    return llpf.make_ukf(lambda x, u, p, t: A @ x, lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=jnp.float32),
                         jnp.eye(2, dtype=jnp.float32), ny=2, nu=0)


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------


def phase_pf(sz) -> list:
    """Bootstrap PF ``loglik`` against the exact KF loglik on the same
    data (Monte-Carlo error only)."""
    import jax
    import lowlevelparticlefilters_jl_tpu as llpf

    kf, _ = _benchmark_kf()
    recs = []
    for N, T, thr in sz["pf"]:
        u, y = _benchmark_data(T)
        pf = _benchmark_pf(N, thr)
        ll_ref = reference(lambda u_, y_: llpf.loglik(kf, u_, y_), u, y)
        ll, t = timed(lambda u_, y_, k: llpf.loglik(pf, u_, y_, key=k),
                      u, y, jax.random.PRNGKey(1))
        t["us_per_step"] = 1e6 * t["run_s"] / T
        step = jax.jit(lambda s, u_, y_: pf.update(s, u_, y_)).lower(
            pf.init(jax.random.PRNGKey(2)), u[0], y[0]).compile()
        ma = step.memory_analysis()
        mem = None if ma is None else {
            k: getattr(ma, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")}
        rec = _record(f"pf[N={N},T={T},thr={thr}]",
                      {"N": N, "T": T, "resample_threshold": thr},
                      {"loglik": t},
                      [_check("loglik rel. error vs exact KF", _rel(ll, ll_ref),
                              sz["tol"]["pf"], "exact KF loglik, " + HIGHEST)])
        rec["pf_step_memory_analysis"] = mem
        recs.append(rec)
    return recs


def phase_resample(sz) -> list:
    """Systematic indices: the bf16 one-hot matmul formulation against
    the scatter-histogram formulation — the same stream, bitwise."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from lowlevelparticlefilters_jl_tpu.ops.resample import (
        _systematic_j_exact, _systematic_j_matmul)

    N = sz["resample_N"]
    both = jax.jit(lambda we, k: (_systematic_j_matmul(we, k),
                                  _systematic_j_exact(we, k, N)))
    mismatches, timing = 0, None
    for seed in (0, 1, 2):
        for skew in (1.0, 20.0):
            u = jax.random.uniform(jax.random.PRNGKey(seed), (N,))
            we = u ** skew
            we = we / jnp.sum(we)
            (jm, je), t = timed(lambda w, k: both(w, k), we,
                                jax.random.PRNGKey(100 + seed))
            timing = timing or t
            mismatches += int(np.sum(np.asarray(jm) != np.asarray(je)))
    return [_record("resample", {"N": N, "seeds": 3, "skews": [1, 20]},
                    {"matmul+scatter": timing},
                    [_check("index mismatches matmul vs scatter",
                            float(mismatches), 0.0, "int32, exact")])]


def _kalman_verbs(f, u, y, sz_name, methods, scale_ref=True):
    """loglik / forward_trajectory / smooth under each method, against
    the sequential scan at highest precision."""
    import lowlevelparticlefilters_jl_tpu as llpf

    def verbs(method):
        return {
            "loglik": lambda u_, y_: llpf.loglik(f, u_, y_, method=method),
            "forward_trajectory": lambda u_, y_: (
                lambda s: (s.ll, s.xt))(
                    llpf.forward_trajectory(f, u_, y_, method=method)),
            "smooth": lambda u_, y_: llpf.smooth(
                f, u_, y_, method=method).xT,
        }

    ref = {k: reference(v, u, y) for k, v in verbs("sequential").items()}
    recs = []
    for method in methods:
        timings, out = {}, {}
        for k, v in verbs(method).items():
            out[k], timings[k] = timed(v, u, y)
        T = int(y.shape[0])
        checks = [
            _check("loglik rel. error", _rel(out["loglik"], ref["loglik"]),
                   1e-5, HIGHEST),
            _check("forward_trajectory ll rel. error",
                   _rel(out["forward_trajectory"][0],
                        ref["forward_trajectory"][0]), 1e-5, HIGHEST),
            _check("xt max-abs / state scale",
                   _maxabs_scaled(out["forward_trajectory"][1],
                                  ref["forward_trajectory"][1]),
                   1e-4, HIGHEST),
            _check("xT max-abs / state scale",
                   _maxabs_scaled(out["smooth"], ref["smooth"]),
                   1e-4, HIGHEST),
        ]
        for t in timings.values():
            t["us_per_step"] = 1e6 * t["run_s"] / T
        recs.append(_record(f"{sz_name}[{method}]", {"T": T},
                            timings, checks))
    return recs


def phase_kf(sz) -> list:
    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(sz["kf_T"])
    return _kalman_verbs(kf, u, y, "kf", ("auto", "parallel"))


def phase_ukf(sz) -> list:
    import jax
    import jax.numpy as jnp

    T = sz["ukf_T"]
    ukf = _cv_ukf()
    ys = jax.random.normal(jax.random.PRNGKey(0), (T, 2), jnp.float32)
    return _kalman_verbs(ukf, None, ys, "ukf", ("auto",))


def phase_bank(sz) -> list:
    import jax
    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf

    Bk, T = sz["bank"]
    kf, _ = _benchmark_kf()
    us = 0.3 * jnp.ones((Bk, T, 1), jnp.float32)
    ys = jax.vmap(lambda k, u: llpf.simulate(kf, u, k)[2])(
        jax.random.split(jax.random.PRNGKey(0), Bk), us)
    ref = reference(lambda u_, y_: jax.vmap(lambda a, b: llpf.loglik(
        kf, a, b, method="sequential"))(u_, y_), us, ys)
    ll, t = timed(lambda u_, y_: llpf.kf_bank_loglik(kf, u_, y_), us, ys)
    ll_vmap, tv = timed(lambda u_, y_: jax.vmap(
        lambda a, b: llpf.loglik(kf, a, b))(u_, y_), us, ys)
    return [_record("bank", {"B": Bk, "T": T},
                    {"kf_bank_loglik": t, "vmap_loglik": tv},
                    [_check("max lane loglik rel. error vs vmap(loglik)",
                            _rel(ll, ref), 1e-5, HIGHEST),
                     _check("vmap(loglik) at default precision, max rel. "
                            "error", _rel(ll_vmap, ref), 1e-5, HIGHEST)])]


def phase_grad(sz) -> list:
    import jax
    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf

    T = sz["grad_T"]
    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(T, seed=3)
    eye = jnp.eye(2, dtype=jnp.float32)

    def g(s, u_, y_):
        return jax.grad(lambda s_: -llpf.loglik(kf.replace(R1=s_ * eye),
                                                u_, y_))(s)

    s0 = jnp.float32(0.01)
    ref = reference(g, s0, u, y)
    out, t = timed(g, s0, u, y)
    return [_record("grad", {"T": T}, {"grad_loglik": t},
                    [_check("d(-loglik)/ds rel. error", _rel(out, ref),
                            1e-4, HIGHEST)])]


def _rows_in(xb_t, xf_t) -> bool:
    """Every row of ``xb_t`` [M, nx] is (bitwise) a row of ``xf_t``."""
    import numpy as np

    def rows(a):
        a = np.ascontiguousarray(a)
        return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1])))[:, 0]

    return bool(np.all(np.isin(rows(xb_t), rows(xf_t))))


def phase_ffbs(sz) -> list:
    """FFBS particle smoother: every returned state is a forward particle
    and the smoothed mean sits within 4 Monte-Carlo standard errors of
    the exact RTS mean."""
    import jax
    import numpy as np
    import lowlevelparticlefilters_jl_tpu as llpf

    M, N, T = sz["ffbs"]
    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(T, seed=4)
    pf = _benchmark_pf(N, 0.1)
    sol = jax.block_until_ready(
        jax.jit(lambda u_, y_: pf.forward_trajectory(
            u_, y_, key=jax.random.PRNGKey(5)))(u, y))
    (xb, _), t = timed(lambda s: llpf.ffbs_smooth(
        pf, s, M, jax.random.PRNGKey(6)), sol)
    xT = np.asarray(reference(lambda u_, y_: llpf.smooth(
        kf, u_, y_, method="sequential").xT, u, y))
    xb, xf = np.asarray(xb), np.asarray(sol.x)
    not_forward = sum(not _rows_in(xb[k], xf[k]) for k in range(T))
    se = xb.std(axis=1) / math.sqrt(M)
    z = float(np.max(np.abs(xb.mean(axis=1) - xT) / np.maximum(se, 1e-12)))
    return [_record("ffbs", {"M": M, "N": N, "T": T},
                    {"ffbs_smooth": t},
                    [_check("steps with a row that is not a forward particle",
                            float(not_forward), 0.0, "exact"),
                     _check("max |mean - RTS mean| / MC std. error", z,
                            sz["tol"]["ffbs_z"], "RTS smoother, " + HIGHEST)])]


def phase_entry(sz) -> list:
    import jax
    import numpy as np
    from __graft_entry__ import entry

    fn, args = entry()
    (_, ll), t = timed(fn, *args)
    ok = float(0.0 if np.isfinite(float(ll)) else 1.0)
    return [_record("entry", {"N": 8192}, {"entry": t},
                    [_check("non-finite ll", ok, 0.0, "finite check")])]


ONE_CARD = (phase_pf, phase_resample, phase_kf, phase_ukf, phase_bank,
            phase_grad, phase_ffbs, phase_entry)


# ---------------------------------------------------------------------------
# Four-card phases (sharded paths only)
# ---------------------------------------------------------------------------


def _mesh(devs, name):
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(devs), (name,))


def mesh_pf(sz, devs) -> list:
    import jax
    import lowlevelparticlefilters_jl_tpu as llpf
    from lowlevelparticlefilters_jl_tpu.parallel import (
        sharded_forward_trajectory)

    N, T = sz["mesh_pf"]
    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(T)
    pf = _benchmark_pf(N, 0.1)
    mesh = _mesh(devs, "particles")
    ll_ref = reference(lambda u_, y_: llpf.loglik(kf, u_, y_), u, y)
    t0 = time.perf_counter()
    ll = jax.block_until_ready(sharded_forward_trajectory(
        pf, u, y, jax.random.PRNGKey(1), mesh)[3])
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(sharded_forward_trajectory(
        pf, u, y, jax.random.PRNGKey(1), mesh)[3])
    t = {"compile_s": first, "run_s": time.perf_counter() - t0,
         "note": "compile_s is the first call (compile + run)"}
    return [_record("mesh_pf_forward", {"N": N, "T": T, "cards": len(devs)},
                    {"sharded_forward_trajectory": t},
                    [_check("ll rel. error vs exact KF", _rel(ll, ll_ref),
                            sz["tol"]["mesh_pf"],
                            "exact KF loglik, " + HIGHEST)])]


def mesh_enkf(sz, devs) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import lowlevelparticlefilters_jl_tpu as llpf
    from lowlevelparticlefilters_jl_tpu.parallel import (
        shard_enkf_state, sharded_enkf_update)

    N = sz["mesh_enkf_N"]
    _, (A, B, C, R1, R2) = _benchmark_kf()
    enkf = llpf.EnsembleKalmanFilter(
        dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: C @ x, R1=R1, R2=R2,
        d0=llpf.MvNormal(jnp.zeros(2, jnp.float32),
                         jnp.eye(2, dtype=jnp.float32)), N=N, nu=1)
    st0 = enkf.init(jax.random.PRNGKey(2))
    u0 = jnp.array([0.3], jnp.float32)
    y0 = jnp.array([0.1, -0.2], jnp.float32)
    mesh = _mesh(devs, "particles")
    st_s = shard_enkf_state(st0, mesh)
    f = jax.jit(lambda s: sharded_enkf_update(enkf, s, u0, y0, mesh=mesh))
    (st1, ll), t = timed(f, st_s)
    st1_ref, info = jax.jit(lambda s: enkf.update(s, u0, y0))(st0)
    m, m_ref = np.asarray(st1.X).mean(0), np.asarray(st1_ref.X).mean(0)
    se = np.asarray(st1_ref.X).std(0) / math.sqrt(N)
    # ll tolerance: the ensemble moments are f32 sums over 1e6 members,
    # reduced per card then across cards — another order than one card's
    return [_record("mesh_enkf", {"N": N, "cards": len(devs)},
                    {"sharded_enkf_update": t},
                    [_check("ll rel. error vs unsharded update",
                            _rel(ll, info.ll), 1e-4, "f32 unsharded"),
                     _check("max |posterior mean diff| / MC std. error",
                            float(np.max(np.abs(m - m_ref) / se)),
                            sz["tol"]["enkf_z"], "f32 unsharded")])]


def mesh_bank(sz, devs) -> list:
    import jax
    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf
    from lowlevelparticlefilters_jl_tpu.parallel import shard_bank

    Bk, T = sz["mesh_bank"]
    kf, _ = _benchmark_kf()
    us = 0.3 * jnp.ones((Bk, T, 1), jnp.float32)
    ys = jax.vmap(lambda k, u: llpf.simulate(kf, u, k)[2])(
        jax.random.split(jax.random.PRNGKey(0), Bk), us)
    f = lambda u_, y_: llpf.kf_bank_loglik(kf, u_, y_)
    ref, _ = timed(f, jax.device_put(us, devs[0]), jax.device_put(ys, devs[0]))
    mesh = _mesh(devs, "bank")
    ll, t = timed(f, shard_bank(us, mesh), shard_bank(ys, mesh))
    return [_record("mesh_bank", {"B": Bk, "T": T, "cards": len(devs)},
                    {"kf_bank_loglik": t},
                    [_check("max lane loglik rel. error vs one card",
                            _rel(ll, ref), 1e-5, "f32 one card")])]


def mesh_time(sz, devs) -> list:
    import jax
    import lowlevelparticlefilters_jl_tpu as llpf
    from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
        time_sharded_parallel_kf, time_sharded_parallel_smooth)

    T = sz["mesh_time_T"]
    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(T)
    mesh = _mesh(devs, "time")
    one = jax.jit(lambda u_, y_: (
        lambda s: (s.sol.xt, s.xT, s.sol.ll))(
            llpf.parallel_rts_smooth(kf, u_, y_)))
    xt_r, xT_r, ll_r = jax.block_until_ready(
        one(jax.device_put(u, devs[0]), jax.device_put(y, devs[0])))
    (xt, _, ll), tf = timed(
        lambda u_, y_: time_sharded_parallel_kf(kf, u_, y_, mesh), u, y)
    (xT, _, xt2, _, ll2), ts = timed(
        lambda u_, y_: time_sharded_parallel_smooth(kf, u_, y_, mesh), u, y)
    return [_record("mesh_time", {"T": T, "cards": len(devs)},
                    {"time_sharded_parallel_kf": tf,
                     "time_sharded_parallel_smooth": ts},
                    [_check("kf ll rel. error vs one card", _rel(ll, ll_r),
                            1e-5, "f32 one card parallel"),
                     _check("kf xt max-abs / state scale",
                            _maxabs_scaled(xt, xt_r), 1e-4,
                            "f32 one card parallel"),
                     _check("smooth ll rel. error vs one card",
                            _rel(ll2, ll_r), 1e-5, "f32 one card parallel"),
                     _check("smooth xT max-abs / state scale",
                            _maxabs_scaled(xT, xT_r), 1e-4,
                            "f32 one card parallel")])]


def mesh_ffbs(sz, devs) -> list:
    import jax
    import numpy as np
    from lowlevelparticlefilters_jl_tpu.parallel import sharded_ffbs_smooth

    M, N, T = sz["mesh_ffbs"]
    u, y = _benchmark_data(T, seed=4)
    pf = _benchmark_pf(N, 0.1)
    mesh = _mesh(devs, "particles")
    t0 = time.perf_counter()
    xb, ll = jax.block_until_ready(sharded_ffbs_smooth(
        pf, u, y, M, jax.random.PRNGKey(6), mesh))
    t = {"compile_s": time.perf_counter() - t0, "run_s": 0.0,
         "note": "one call, compile included"}
    bad = float(0.0 if (np.all(np.isfinite(np.asarray(xb)))
                        and np.isfinite(float(ll))
                        and xb.shape == (T, M, 2)) else 1.0)
    return [_record("mesh_ffbs", {"M": M, "N": N, "T": T,
                                  "cards": len(devs)},
                    {"sharded_ffbs_smooth": t},
                    [_check("non-finite or misshapen output", bad, 0.0,
                            "finite/shape check")])]


def mesh_pmmh(sz, devs) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import lowlevelparticlefilters_jl_tpu as llpf
    from lowlevelparticlefilters_jl_tpu.paramest import metropolis_parallel

    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(200)
    eye = jnp.eye(2, dtype=jnp.float32)

    def ll(th):
        return llpf.loglik(kf.replace(R1=jnp.exp(th[0]) * eye), u, y)

    kw = dict(key=jax.random.PRNGKey(7), n_chains=8 * len(devs))
    th0 = jnp.array([jnp.log(0.01)], jnp.float32)
    t0 = time.perf_counter()
    on_mesh = jax.block_until_ready(metropolis_parallel(
        10, ll, 60, th0, mesh=_mesh(devs, "chains"), **kw))
    t = {"compile_s": time.perf_counter() - t0, "run_s": 0.0,
         "note": "one call, compile included"}
    one = jax.block_until_ready(metropolis_parallel(10, ll, 60, th0, **kw))
    # Metropolis chains are discontinuous in their inputs (one flipped
    # accept diverges a chain), so the comparison is statistical: the
    # posterior means of theta agree within 4 between-chain standard
    # errors; the share of bitwise-equal chains is reported beside it.
    C = kw["n_chains"]
    m_mesh = np.asarray(on_mesh)[:, 0].reshape(C, -1).mean(1)
    m_one = np.asarray(one)[:, 0].reshape(C, -1).mean(1)
    se = math.sqrt((m_mesh.var() + m_one.var()) / C) + 1e-12
    rec = _record("mesh_pmmh", {"chains": C, "R": 60, "cards": len(devs)},
                  {"metropolis_parallel": t},
                  [_check("|posterior mean diff| / std. error, mesh vs vmap",
                          float(abs(m_mesh.mean() - m_one.mean()) / se), 4.0,
                          "f32 vmap, one card")])
    rec["identical_chains"] = float(np.mean(m_mesh == m_one))
    return [rec]


def mesh_segment_pf(sz, devs) -> list:
    import jax
    import lowlevelparticlefilters_jl_tpu as llpf
    from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
        sharded_pf_loglik_fused)

    N, T, seg = sz["mesh_segment_pf"]
    kf, _ = _benchmark_kf()
    u, y = _benchmark_data(T)
    pf = _benchmark_pf(N, 0.1)
    ll_ref = reference(lambda u_, y_: llpf.loglik(kf, u_, y_), u, y)
    f4 = lambda u_, y_: sharded_pf_loglik_fused(
        pf, u_, y_, jax.random.PRNGKey(3), _mesh(devs, "particles"),
        segment=seg)
    f1 = lambda u_, y_: sharded_pf_loglik_fused(
        pf, u_, y_, jax.random.PRNGKey(3), _mesh(devs[:1], "particles"),
        segment=seg)
    ll4, t4 = timed(f4, u, y)
    ll1, t1 = timed(f1, u, y)
    return [_record("mesh_segment_pf", {"N": N, "T": T, "segment": seg,
                                        "cards": len(devs)},
                    {"four_cards": t4, "one_card_segment_body": t1},
                    [_check("4-card ll rel. error vs exact KF",
                            _rel(ll4, ll_ref), sz["tol"]["segment_pf"],
                            "exact KF loglik, " + HIGHEST),
                     _check("1-card segment-body ll rel. error vs exact KF",
                            _rel(ll1, ll_ref), sz["tol"]["segment_pf"],
                            "exact KF loglik, " + HIGHEST)])]


FOUR_CARD = (mesh_pf, mesh_enkf, mesh_bank, mesh_time, mesh_ffbs, mesh_pmmh,
             mesh_segment_pf)


# ---------------------------------------------------------------------------


def run_phases(phases, sz, *args) -> list:
    """Run each phase, print its records, and return the names of the
    failed ones.  A phase that raises is reported and counts as failed."""
    failed = []
    for ph in phases:
        try:
            recs = ph(sz, *args)
        except Exception as e:  # report, fail the run, go on to the next
            recs = [{"phase": ph.__name__, "pass": False,
                     "error": f"{type(e).__name__}: {e}"[:2000]}]
        for r in recs:
            _emit(r)
            if not r["pass"]:
                failed.append(r["phase"])
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, over four GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    devs = require_gpu(n_cards)[:n_cards]
    sys.path.insert(0, HERE)
    from lowlevelparticlefilters_jl_tpu.utils.compile_cache import (
        enable_compile_cache)

    print(f"compile cache: {enable_compile_cache(HERE)}", flush=True)
    print(card_line(devs), flush=True)
    if args.four_cards:
        failed = run_phases(FOUR_CARD, FULL, devs)
    else:
        failed = run_phases(ONE_CARD, FULL)
    _emit({"peak_bytes_in_use": peak_bytes(devs)})
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if failed:
        _emit({"ok": False, "failed": failed, "device": device})
        return 1
    _emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
