"""Multi-host helpers + kernel-validation utilities."""

import numpy as np

import jax
import jax.numpy as jnp


def test_shard_fastq_roundtrip(tmp_path):
    from bucketmap_tpu.parallel.distributed import shard_fastq
    from bucketmap_tpu.io.fastq import read_fastq

    src = tmp_path / "r.fastq"
    with open(src, "w") as f:
        for i in range(10):
            f.write(f"@read{i}\nACGTACGT\n+\nEEEEEEEE\n")
    p0 = shard_fastq(src, tmp_path, 3, 0)
    p1 = shard_fastq(src, tmp_path, 3, 1)
    p2 = shard_fastq(src, tmp_path, 3, 2)
    all_ids = []
    for p in (p0, p1, p2):
        all_ids += read_fastq(p).ids
    assert sorted(all_ids) == sorted(f"read{i}" for i in range(10))
    assert read_fastq(p1).ids == ["read1", "read4", "read7"]


def test_global_read_batch_over_mesh():
    from bucketmap_tpu.parallel.distributed import global_read_batch
    from bucketmap_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(8)
    n_data = mesh.shape["data"]
    B = 2 * n_data
    codes = np.arange(B * 4, dtype=np.uint8).reshape(B, 4)
    quals = np.full((B, 4), 30, np.uint8)
    lengths = np.full(B, 4, np.int32)
    gc, gq, gl = global_read_batch(mesh, codes, quals, lengths)
    assert gc.shape == (B, 4)
    np.testing.assert_array_equal(np.asarray(gc), codes)
    assert gc.sharding.spec[0] == "data"


def test_validation_mode_and_checked():
    from bucketmap_tpu.utils.debug import checked, validation_mode

    with validation_mode():
        x = jnp.asarray([1.0, 2.0]) + 1
        np.testing.assert_allclose(np.asarray(x), [2.0, 3.0])

    def f(i):
        return jnp.zeros(4).at[i].get()

    err, _ = checked(jax.jit(f))(jnp.int32(2))
    assert err.get() is None
    err, _ = checked(jax.jit(f))(jnp.int32(17))
    assert err.get() is not None and "out-of-bounds" in err.get()

def test_resource_report(monkeypatch):
    """resource_report mirrors /usr/bin/time -v's peak-RSS discipline
    (benchmark/README.md:89-130): host RSS always present; the device
    peak comes from memory_stats() — None on the CPU, and an error on
    an accelerator that reports none (never an estimate)."""
    import pytest

    from bucketmap_tpu.utils import debug

    r = debug.resource_report()
    assert r["peak_host_rss_kb"] > 1000  # a python process is >1 MB
    assert set(r) == {"peak_host_rss_kb", "device_hbm_peak_bytes",
                      "device_hbm_limit_bytes"}
    assert r["device_hbm_peak_bytes"] is None
    assert r["device_hbm_limit_bytes"] is None

    class _Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    stats = {"peak_bytes_in_use": 5 << 30, "bytes_limit": 60 << 30}
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(stats)])
    r = debug.resource_report()
    assert r["device_hbm_peak_bytes"] == 5 << 30
    assert r["device_hbm_limit_bytes"] == 60 << 30
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(None)])
    with pytest.raises(RuntimeError, match="memory_stats"):
        debug.resource_report()
