"""The accelerator the program runs on: a GPU check, the card's name
and power limit, and the persistent compile cache."""

from __future__ import annotations

import os
import subprocess

# <repo>/.jax_cache: a fixed path, so one checkout's runs share entries
# (the path is part of the cache key); listed in .gitignore
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it. When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
    and nothing is set here; otherwise the cache is REPO_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu(program: str):
    """The JAX devices, when the first one is a GPU; otherwise exit with
    status 1 and a message naming the missing GPU. A measurement never
    falls back to the CPU."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"{program}: no GPU: JAX found no devices ({e})")
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{program}: no GPU: JAX found only {devs[0].platform} "
            f"devices; this program measures an NVIDIA GPU")
    return devs


def gpu_name_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the visible cards,
    one CSV line each (a card below its maximum power runs slower under
    load, so every number is reported beside this)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
