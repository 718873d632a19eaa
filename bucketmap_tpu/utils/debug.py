"""Kernel-validation utilities — the JAX counterpart of the reference's
(absent) sanitizer story (SURVEY §5 'race detection / sanitizers':
jit-disable + checkify/debug_nans for kernel validation).

  * ``validation_mode()`` — context manager enabling ``jax_debug_nans``
    and ``jax_disable_jit`` so every op runs eagerly with NaN checks;
    use to localize a miscompiling/misbehaving kernel.
  * ``checked(fn)`` — wraps a jitted function with ``checkify`` so
    out-of-bounds indexing and NaN/div checks become checkable errors
    instead of silent clamps.
  * ``maybe_trace()`` — jax.profiler trace hook, enabled by the
    BMTPU_PROFILE=<dir> env var or an explicit dir (the counterpart of
    the reference's Timer/[BENCHMARK] instrumentation, SURVEY §5
    'tracing': load the trace in TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None = None):
    """Profile the enclosed block with jax.profiler when enabled.

    Enabled when `trace_dir` is given or BMTPU_PROFILE is set; no-op
    (zero overhead) otherwise.
    """
    d = trace_dir or os.environ.get("BMTPU_PROFILE")
    if not d:
        yield
        return
    import jax

    with jax.profiler.trace(d):
        yield


@contextlib.contextmanager
def validation_mode(disable_jit: bool = True):
    import jax

    with jax.debug_nans(True):
        if disable_jit:
            with jax.disable_jit():
                yield
        else:
            yield


def resource_report() -> dict:
    """Peak host RSS + device memory peak, mirroring the reference
    harness's `/usr/bin/time -v` discipline (benchmark/README.md:89-130:
    every run records wall + maximum resident set size).

    Returns {"peak_host_rss_kb": int,
             "device_hbm_peak_bytes": int | None,
             "device_hbm_limit_bytes": int | None}. The device fields come
    from the first device's memory_stats(); they are None on the CPU,
    which keeps no such statistics. Any other device that reports none
    is an error: a peak is never estimated.
    """
    import resource

    import jax

    dev = jax.local_devices()[0]
    ms = dev.memory_stats()
    if dev.platform != "cpu" and not (ms and "peak_bytes_in_use" in ms):
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no "
            f"memory_stats() peak")
    ms = ms or {}
    return {"peak_host_rss_kb": int(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss),
        "device_hbm_peak_bytes": ms.get("peak_bytes_in_use"),
        "device_hbm_limit_bytes": ms.get("bytes_limit")}


def checked(fn, *, errors=None):
    """checkify-wrap fn: returns (error, result); call error.throw() to
    raise on failures. Adds index OOB + float checks by default."""
    from jax.experimental import checkify

    errs = errors if errors is not None else (
        checkify.index_checks | checkify.float_checks)
    return checkify.checkify(fn, errors=errs)
