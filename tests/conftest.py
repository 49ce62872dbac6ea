"""Test harness config: force CPU with 8 virtual devices.

This mirrors how the reference exercises multi-node behaviour without a
cluster — Spark local[4] threads stand in for executors
(reference: src/main/scala/skc/test/LocalTestKmerCounter.scala:62); here an
8-device virtual CPU mesh stands in for a multi-GPU host.

XLA_FLAGS is read when the CPU backend starts, so the virtual device count
takes effect as long as it is set before the first CPU computation (test
modules are collected after ``pytest_configure``).  The compilation cache
goes to a fixed directory under the temp dir, never into the checkout.
Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them on the CPU; ``python -m pytest -m gpu tests`` on a
GPU machine runs them there.
"""

import os
import tempfile

import jax
import pytest


def _pin_cpu() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(tempfile.gettempdir(), "fastkmer-test-xla-cache"),
    )
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])


def pytest_configure(config):
    # ``-m gpu`` selects the card-only checks (chip_smoke.py runs them in
    # its own process on the card): leave the platform as the caller set it
    if config.getoption("markexpr") != "gpu":
        _pin_cpu()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the process has none.
    Decided here, at run time — never at import or collection."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return devs[0]
