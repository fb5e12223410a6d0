"""``golf_tpu_torch.utils.profiling`` on the CPU: the trace file, the FLOP
count of known ops, the timed call and the NaN trap."""

import json
import os

import pytest
import torch

from golf_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(tmp_path)
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_cost_analysis_counts_matmul_flops():
    a, b = torch.ones(16, 32), torch.ones(32, 8)
    out = profiling.cost_analysis(torch.matmul, a, b)
    assert out["flops"] == 2 * 16 * 32 * 8
    assert sum(out["by_op"].values()) == out["flops"]


def test_timed_returns_seconds_on_the_cpu():
    t = profiling.timed(lambda: torch.ones(64).sum(), n=5, device="cpu")
    assert 0 < t < 1


def test_nan_debugging_traps_the_backward():
    profiling.enable_nan_debugging(True)
    try:
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
