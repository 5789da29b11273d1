"""Test harness: run everything on 8 fake CPU devices.

This is the standard JAX trick for testing distributed code without a pod
(SURVEY.md §4.2 item 4): the exact shard_map/collective code paths run in
CI on the CPU backend with 8 virtual devices.  Must set env vars before
jax is imported anywhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin the CPU backend through jax.config before any backend starts,
# unless JAX_PLATFORMS names the platforms (the GPU-marked tests run on
# the card with JAX_PLATFORMS=cuda,cpu).
import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_grid():
    from base_tpu.grids import synthetic

    return synthetic.make_grid(
        feh_axis=np.linspace(-1.5, 0.3, 4),
        y_axis=np.linspace(0.24, 0.31, 3),
        age_axis=np.linspace(8.6, 10.1, 6),
        n_eep=48,
    )
