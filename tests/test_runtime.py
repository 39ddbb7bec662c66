"""Process set-up helpers, the benchmark's peak table, the profiler's trace
reduction and the native engine's first-use build."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

import bench
from qrkit_tpu import profiling, runtime


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper sets
    nothing of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))

    def refuse(*a, **k):
        raise AssertionError("enable_compile_cache must not touch jax.config")

    monkeypatch.setattr(jax.config, "update", refuse)
    assert runtime.enable_compile_cache() == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    got = runtime.enable_compile_cache()
    root = Path(__file__).resolve().parent.parent
    assert got == str(root / ".jax_cache") == str(runtime.CACHE_DIR)
    assert calls == [("jax_compilation_cache_dir", got)]
    # the same path on every call: no pid, time or temp name in it
    assert runtime.enable_compile_cache() == got
    assert ".jax_cache/" in (root / ".gitignore").read_text()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit):
        runtime.require_gpu()


def test_peak_table():
    assert bench.peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError, match="no peak bandwidth"):
        bench.peak_hbm_bytes_per_s("NVIDIA A100-SXM4-40GB")


def test_trace_raises_when_profiler_cannot_start(monkeypatch, tmp_path):
    def fail(_):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(jax.profiler, "start_trace", fail)
    with pytest.raises(RuntimeError, match="profiler busy"):
        with profiling.trace(str(tmp_path)):
            pass


def test_stage_device_times_attributes_named_scopes(tmp_path):
    """The trace reduction maps each executed op through its HLO metadata to
    the named scope it ran under (CPU executor events stand in for device
    kernels here)."""

    @jax.jit
    def f(x):
        with jax.named_scope("stage_a"):
            y = jnp.sin(x) @ x
        with jax.named_scope("stage_b"):
            z = jnp.cos(y)
        return z

    x = jnp.ones((128, 128), jnp.float32)
    f(x).block_until_ready()
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    events = profiling.device_events(str(tmp_path), plane_prefix="/host:CPU")
    red = profiling.stage_device_times(
        events, [f.lower(x).compile().as_text()], ["stage_a", "stage_b"]
    )
    assert red["stage_ns"]["stage_a"] > 0 and red["stage_ns"]["stage_b"] > 0
    assert 0 < red["busy_ns"] <= red["window_ns"]


def test_hlo_op_names_resolves_fusions():
    text = """HloModule jit_f, entry_computation_layout={()->f32[]}
%fused_computation (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  ROOT %sin.0 = f32[4]{0} sine(%p), metadata={op_name="jit(f)/stage_a/sin"}
}
ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  ROOT %loop_fusion = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation
}
"""
    mod, names = profiling.hlo_op_names(text)
    assert mod == "jit_f"
    assert names["loop_fusion"] == "jit(f)/stage_a/sin"


def test_native_engine_builds_on_first_use(monkeypatch, tmp_path):
    """The host engine compiles from native/qrkit_host.cpp into the build
    directory (temp file + atomic rename) and loads."""
    import ctypes

    from qrkit_tpu import _native

    if _native.shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on this host")
    so = tmp_path / "build" / "libqrkit_host.so"
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_SO", str(so))
    assert _native._build() == str(so)
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["libqrkit_host.so"]
    lib = ctypes.CDLL(str(so))
    assert hasattr(lib, "qrkit_abap_order")
    # up to date: no second compile
    mtime = so.stat().st_mtime_ns
    assert _native._build() == str(so) and so.stat().st_mtime_ns == mtime
