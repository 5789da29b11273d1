"""Checks that need the card: the fused kernel compiled for the GPU
against the plain marginal, GPU-vs-CPU precision of log_post, and a
bit-identical resume.  They call the same functions as chip_smoke.py, at
smaller sizes.  Without a GPU they skip.  On the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu
"""
import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu

SETS = ("simCluster.nStars=40",)


@pytest.fixture(scope="module")
def model():
    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is "
                    f"{jax.devices()[0].platform}")
    return chip_smoke.config1_model(n_stars=40, sets=SETS)


def test_gpu_kernel_parity(model):
    chip_smoke.check_kernel_parity(*model, n_tables=8)


def test_gpu_precision_against_cpu(model):
    chip_smoke.check_precision(*model, n_points=8)


def test_gpu_resume_bit_identical(model, tmp_path):
    chip_smoke.check_resume(*model, tmp_path, chunk=4, n_chunks=2,
                            warmup=16, l_max=8, n_chains=8)
