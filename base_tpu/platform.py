"""The device the program runs on, and what follows from it.

Three decisions live here and nowhere else:

- which device JAX found (`device_info`), and a hard stop for measuring
  entry points that must not fall back to the CPU (`require_gpu`);
- which implementation a hot operation compiles to (`by_platform`): the
  choice is made when the computation is lowered for its device, so one
  traced function runs the GPU kernel on the card and the plain jnp
  version on the CPU, in the same process;
- where compiled programs are cached between processes
  (`setup_compile_cache`).
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def device_info() -> dict:
    """{"platform", "kind", "count"} of the default devices, as JAX
    reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or RuntimeError when JAX found no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {info['platform']} "
            f"({info['kind']}); this entry point measures the GPU only"
        )
    return info


def by_platform(*args, gpu, default):
    """`gpu(*args)` where the computation is compiled for a CUDA device,
    `default(*args)` everywhere else.  Both are traced; only the one for
    the target device is lowered."""
    return jax.lax.platform_dependent(*args, cuda=gpu, default=default)


def setup_compile_cache() -> str:
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX
    reads it itself), else <repo>/.jax_cache.  Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
