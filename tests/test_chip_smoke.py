"""chip_smoke.py on the CPU: its phase functions at tiny sizes, its
refusal to run without a GPU, and the compile-cache helper.

The script's real run is on the card (``python chip_smoke.py``); here
the phases run on the CPU backend with small shapes and Monte-Carlo
tolerances loosened to match, so the control flow, the references and
the checks are exercised without a device.
"""
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = {
    "pf": [(2048, 40, 0.1), (2048, 40, 1.0)],
    "resample_N": 4096,
    "kf_T": 64,
    "ukf_T": 64,
    "bank": (16, 32),
    "grad_T": 64,
    "ffbs": (64, 512, 12),
    "mesh_pf": (4096, 16),
    "mesh_enkf_N": 4096,
    "mesh_bank": (32, 16),
    "mesh_time_T": 64,
    "mesh_ffbs": (16, 512, 8),
    "mesh_segment_pf": (4096, 32, 8),
    "tol": {"pf": 0.03, "mesh_pf": 0.03, "segment_pf": 0.05,
            "ffbs_z": 6.0, "enkf_z": 6.0},
}


def _name(f):
    return f.__name__


@pytest.mark.parametrize("phase", chip_smoke.ONE_CARD, ids=_name)
def test_one_card_phase_tiny(phase):
    for rec in phase(TINY):
        assert rec["pass"], rec
        assert rec["compile_s"] >= 0 and rec["run_s"] >= 0
        for c in rec["checks"]:
            assert {"quantity", "value", "tol", "ref_precision",
                    "pass"} <= set(c)


@pytest.mark.parametrize("phase", chip_smoke.FOUR_CARD, ids=_name)
def test_four_card_phase_tiny(phase):
    devs = jax.devices()[:4]
    for rec in phase(TINY, devs):
        assert rec["pass"], rec


def test_run_phases_reports_a_raising_phase(capsys):
    def broken(sz):
        raise RuntimeError("boom")

    failed = chip_smoke.run_phases((broken,), TINY)
    assert failed == ["broken"]
    assert '"error": "RuntimeError: boom"' in capsys.readouterr().out


def test_refuses_cpu_device():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(1)
    assert e.value.code != 0


def test_script_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from lowlevelparticlefilters_jl_tpu.utils import compile_cache

    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "c"))
        assert compile_cache.enable_compile_cache(REPO) == str(tmp_path / "c")
        assert seen == {}
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        path = compile_cache.enable_compile_cache(REPO)
        assert path == os.path.join(REPO, ".jax_cache")
        assert seen == {"jax_compilation_cache_dir": path}
