"""Runtime-layer tests: timing harness, metrics sink, distributed helpers."""

import json

import numpy as np
import jax
import jax.numpy as jnp

from icp_tpu.runtime.metrics import MetricsSink
from icp_tpu.runtime.timing import CPUTimer, ProfilingInfo, device_time


def test_cpu_timer():
    with CPUTimer() as t:
        x = sum(range(100000))
    assert t.span_ms > 0


def test_device_time_runs():
    f = jax.jit(lambda x: x * 2 + 1)
    ms = device_time(f, jnp.ones((64, 64)), reps=2)
    assert ms >= 0


def test_profiling_info_summary():
    info = ProfilingInfo("test")
    with info.span("phase_a"):
        pass
    info.record("phase_b", 1.5)
    info.record("phase_b", 2.5)
    s = info.summary()
    assert "phase_a" in s and "phase_b" in s
    assert abs(info.mean("phase_b") - 2.0) < 1e-9
    assert abs(info.total("phase_b") - 4.0) < 1e-9


def test_metrics_sink_roundtrip(tmp_path):
    sink = MetricsSink(run_id="r1")
    sink.log("fps", 30.5, config="flagship")
    sink.log("fps", 29.5)
    sink.log("ate_mm", 4.2)
    s = sink.summary()
    assert s["fps"]["count"] == 2
    assert abs(s["fps"]["mean"] - 30.0) < 1e-9

    p = str(tmp_path / "metrics.jsonl")
    sink.dump_jsonl(p)
    back = MetricsSink.load_jsonl(p)
    assert len(back.records) == 3
    assert back.records[0]["config"] == "flagship"


def test_metrics_log_registration():
    from icp_tpu.icp.state import identity_state

    sink = MetricsSink()
    sink.log_registration(identity_state(), 12.5, pair="a-b")
    names = {r["metric"] for r in sink.records}
    assert {"icp.iterations", "icp.latency_ms", "icp.angle_deg",
            "icp.translation_mm", "icp.scale"} <= names


def test_config_validation():
    import pytest

    from icp_tpu import ICPConfig

    with pytest.raises(ValueError):
        ICPConfig(m=0)  # ref: "cannot have zero points"
    with pytest.raises(ValueError):
        ICPConfig(n_r=0)
    with pytest.raises(ValueError):
        ICPConfig(n_r=6)  # ref cpp:845-854: n_r must be a multiple of 4


def test_config_capacity_defaults():
    """Pin the auto-capacity policy: bin = 2x mean occupancy rounded up to
    a multiple of 128 (whole candidate tiles), query = 1.5x mean
    occupancy, 8-aligned (whole query tiles). Trade-off documented in
    ICPConfig; a silent change here moves both perf and the overflow rate."""
    from icp_tpu import ICPConfig

    flagship = ICPConfig()  # m=16384, n_r=256 -> mean occupancy 64
    assert flagship.bin_capacity == 128
    assert flagship.query_capacity == 96

    big = ICPConfig(m=65536, n_r=1024)  # mean occupancy 64 again
    assert big.bin_capacity == 128
    assert big.query_capacity == 96

    tiny = ICPConfig(m=64, n_r=16)  # mean occupancy floor (4) -> min 16
    assert tiny.bin_capacity >= 16
    assert tiny.query_capacity >= 16
    assert tiny.query_capacity % 8 == 0

    # Explicit values pass through untouched.
    explicit = ICPConfig(bin_capacity=64, query_capacity=40)
    assert explicit.bin_capacity == 64
    assert explicit.query_capacity == 40


def test_make_global_mesh_single_process():
    from icp_tpu.parallel.distributed import make_global_mesh

    mesh = make_global_mesh(n_mp=2)
    assert mesh.shape["mp"] == 2
    assert mesh.shape["dp"] == len(jax.devices()) // 2


def test_local_shard_single_process():
    from icp_tpu.parallel.distributed import local_shard, make_global_mesh

    mesh = make_global_mesh(n_mp=1)
    arr = np.arange(16 * 3).reshape(16, 3)
    sl = local_shard(arr, mesh)
    # Single process owns all rows.
    np.testing.assert_array_equal(sl, arr)
