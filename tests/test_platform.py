"""The platform module: device report, the GPU-only guard, the compile
cache's place, and chip_smoke.py's refusal to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from base_tpu import platform

ROOT = Path(__file__).resolve().parents[1]


def test_device_info_reports_the_cpu():
    info = platform.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_require_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_by_platform_runs_default_on_cpu():
    out = jax.jit(lambda x: platform.by_platform(
        x, gpu=lambda v: v + 1.0, default=lambda v: v - 1.0))(2.0)
    assert float(out) == 1.0


def _cache_dir_in_child(env_dir):
    """setup_compile_cache() in a fresh process (it sets global config)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (
        "import json, jax; from base_tpu import platform; "
        "d = platform.setup_compile_cache(); "
        "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_default_is_fixed_inside_checkout():
    got, cfg = _cache_dir_in_child(None)
    assert got == cfg == str(ROOT / ".jax_cache")
    assert platform.DEFAULT_CACHE_DIR == ROOT / ".jax_cache"


def test_compile_cache_honours_env(tmp_path):
    got, cfg = _cache_dir_in_child(str(tmp_path / "cc"))
    assert got == cfg == str(tmp_path / "cc")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_chip_smoke_fails_on_cpu():
    _assert_refused(_run_smoke(ROOT, ROOT / "chip_smoke.py"))


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run_smoke(tmp_path, tmp_path / "chip_smoke.py"))


@pytest.fixture(scope="module")
def tiny_model():
    import chip_smoke

    return chip_smoke.config1_model(
        n_stars=12, sets=("mcmc.upsample=1", "mcmc.nMassRatio=4"))


def _sampler_program(kind, model):
    import jax.numpy as jnp

    from base_tpu.inference import hmc, mh, nuts, vi
    from base_tpu.model import posterior as post

    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    key = jax.random.PRNGKey(0)
    z = jnp.zeros((2, 9), jnp.float32)
    if kind == "hmc":
        cfg = hmc.HMCConfig(n_warmup=4, n_samples=2, l_max=2,
                            dense_mass=True, n_windows=1)
        return lambda zz: hmc.run_hmc(fz, zz, key, cfg), z
    if kind == "nuts":
        cfg = nuts.NUTSConfig(n_warmup=2, n_samples=2, max_depth=2,
                              dense_mass=True, n_windows=1)
        return lambda zz: nuts.run_nuts(fz, zz, key, cfg), z
    if kind == "mh":
        cfg = mh.MHConfig(n_stage1=4, n_stage2=4, n_main=2, adapt_every=2)
        f = post.make_logpost_fn(model)
        return lambda x: mh.run_adaptive_mh(
            f, x, key, jnp.full((9,), 0.01), cfg), z[0] + 9.0
    cfg = vi.VIConfig(n_steps=2, n_mc=2, full_rank=True)
    return lambda zz: vi.run_vi(fz, zz, key, cfg), z[0]


@pytest.mark.parametrize("kind", ["hmc", "nuts", "mh", "vi"])
def test_gpu_programs_ask_for_full_float32_products(tiny_model, kind):
    """Lowered for CUDA (no card needed), every matrix product of the
    density and the sampler asks for HIGHEST precision, so none runs in
    TF32."""
    fn, arg = _sampler_program(kind, tiny_model[0])
    text = jax.jit(fn).trace(arg).lower(
        lowering_platforms=("cuda",)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    assert not [ln for ln in dots if "HIGHEST" not in ln]
