"""Test configuration: run on CPU with 8 virtual devices and float64.

Multi-device sharding tests follow the reference survey's strategy
(SURVEY.md §4): validate mesh code on a virtual CPU mesh via
``xla_force_host_platform_device_count``; numeric parity tests use x64 to
match the Julia suite's tolerances.
"""
import os

# The suite runs on the CPU backend even where an accelerator is visible;
# jax.config.update below makes that hold if jax was imported earlier.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
