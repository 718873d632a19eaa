"""What the program decides from the device it runs on: where the
occupancy table is built, the compile cache's directory, the fine-index
budget, and the refusal of the GPU-only entry points to run without a
GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import build_index
from bucketmap_tpu.sim.simulator import random_genome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_index():
    cfg = MapperConfig(bucket_len=1024, read_len=300)
    return build_index(random_genome(8 * 1024, seed=3), cfg)


@pytest.mark.parametrize("platform,on_device", [("gpu", True),
                                                ("cpu", False)])
def test_occupancy_build_choice_by_platform(small_index, monkeypatch,
                                            platform, on_device):
    """On an accelerator the coarse table is built on the device from the
    genome; on the CPU the host table is uploaded. Same table either way."""
    from bucketmap_tpu.index import device_build
    from bucketmap_tpu.ops.coarse import CoarseMapper

    calls = []
    build = device_build.build_occupancy_on_device
    monkeypatch.setattr(device_build, "build_occupancy_on_device",
                        lambda *a, **k: calls.append(1) or build(*a, **k))
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.delenv("BMTPU_DEVICE_OCC", raising=False)
    table = np.asarray(CoarseMapper(small_index).qgram_words)
    assert bool(calls) is on_device
    np.testing.assert_array_equal(table, small_index.qgram_words)


def _record_config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from bucketmap_tpu.utils.device import setup_compile_cache

    calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_is_fixed(monkeypatch):
    from bucketmap_tpu.utils.device import setup_compile_cache

    calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first, second = setup_compile_cache(), setup_compile_cache()
    assert first == second == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2


class _Device:
    def __init__(self, bytes_limit):
        self.bytes_limit = bytes_limit

    def memory_stats(self):
        return (None if self.bytes_limit is None
                else {"bytes_limit": self.bytes_limit})


def test_fine_index_budget_from_bytes_limit(small_index):
    from bucketmap_tpu.mapper.device_pipeline import (fine_index_budget,
                                                      fine_index_fits)

    gib = 1 << 30
    # a quarter of the limit stays free for the batch, then the other
    # resident tables come off
    assert fine_index_budget(60 * gib, 2 * gib) == 43 * gib
    assert fine_index_budget(16 * gib, 0) == 12 * gib
    lb = small_index.buckets_packed.shape[1] * 16
    need = 4 * small_index.n_buckets * lb
    assert fine_index_fits(small_index, _Device(60 * gib))
    # shrink the limit until the table no longer fits
    assert not fine_index_fits(small_index, _Device(need))
    # two bucket shards each hold half the rows
    assert fine_index_fits(small_index, _Device(60 * gib), shards=2)


def test_fine_index_budget_needs_a_limit(small_index):
    from bucketmap_tpu.mapper.device_pipeline import fine_index_fits

    with pytest.raises(RuntimeError, match="bytes_limit"):
        fine_index_fits(small_index, _Device(None))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_programs_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; the test skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev


@pytest.mark.gpu
def test_gpu_reports_memory_stats(gpu):
    """The device-memory numbers every GPU run reports come from
    memory_stats(); a GPU without them fails the run."""
    from bucketmap_tpu.utils.debug import resource_report

    x = jax.device_put(np.ones((1 << 20,), np.float32), gpu)
    r = resource_report()
    assert r["device_hbm_peak_bytes"] >= x.nbytes
    assert r["device_hbm_limit_bytes"] > r["device_hbm_peak_bytes"]
