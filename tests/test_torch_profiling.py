"""``golf_tpu_torch.utils.profiling`` on the CPU: the trace file, the FLOP
count of known ops, the NaN trap, and the recorder: off it is the
identity and leaves no range in a profile; on, the spans' parents, steps
and order forward and backward, self time, counters by span, its ranges in
the Chrome trace, and a tiny GOLF-ss training step and predict equal bit
for bit on and off."""

import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch
from torch import nn

from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.utils import profiling
from tests.test_torch_parallel_dp import make_inputs, tiny_cfg

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


def test_nan_debugging_traps_the_backward():
    profiling.enable_nan_debugging(True)
    try:
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


class Toy(nn.Module):
    """Three stages: ``a`` on an input that needs no gradient, ``b`` and
    ``c`` on a Sig and a dict of them."""

    def __init__(self):
        super().__init__()
        self.a = nn.Linear(4, 4)
        self.b = nn.Linear(4, 4)
        self.c = nn.Linear(4, 2)

    def forward(self, x):
        with profiling.span("toy"):
            h = profiling.leave("a", self.a(profiling.enter("a", x)))
            h = profiling.enter("b", Sig(h, 1))
            h = profiling.leave("b", {"h": Sig(torch.tanh(self.b(h.data)), 1),
                                      "hop": 1})
            h = profiling.enter("c", h)["h"].data
            return profiling.leave("c", self.c(h))


def test_recorder_off_is_the_identity_and_leaves_no_range():
    x = torch.ones(3, 4, requires_grad=True)
    y = x * 2
    tree = {"y": Sig(y, 1), "l": [y]}
    with torch.profiler.profile() as prof:
        assert profiling.enter("a", y) is y
        assert profiling.leave("a", tree) is tree
        assert y.grad_fn.name() == "MulBackward0"
        with profiling.span("s"):
            profiling.count("n")
        profiling.begin_step()
        profiling.backward_done()
        Toy()(x).sum().backward()
    assert not [e.name for e in prof.events()
                if e.name.startswith(profiling.RANGE)]


def test_recorder_nesting_raises():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == []


def test_spans_forward_and_backward_in_order():
    model, x = Toy(), torch.randn(3, 4)
    with profiling.recording() as rec:
        for _ in range(2):
            profiling.begin_step()
            with profiling.span("step"):
                model(x).sum().backward()
                profiling.backward_done()
    assert rec.steps == 2
    spans = rec.spans
    step0 = [s for s in spans if s.step == 0]
    assert [s.name for s in step0] == [
        "step", "toy", "a.fwd", "b.fwd", "c.fwd",
        "c.bwd", "b.bwd", "a.bwd"]
    by = {s.name: i for i, s in enumerate(spans) if s.step == 0}
    assert spans[by["toy"]].parent == by["step"]
    for name in ("a.fwd", "b.fwd", "c.fwd"):
        assert spans[by[name]].parent == by["toy"]
    # backward spans open under the span the backward was called in
    for name in ("a.bwd", "b.bwd", "c.bwd"):
        assert spans[by[name]].parent == by["step"]
    assert [s.step for s in spans if s.name.endswith(".bwd")] == \
        [0, 0, 0, 1, 1, 1]
    # a's input needs no gradient: a.bwd closes at backward_done, after b's
    assert spans[by["a.bwd"]].host_end_ns >= spans[by["b.bwd"]].host_end_ns
    assert all(s.host_end_ns >= s.host_start_ns for s in spans)
    totals = rec.totals()
    assert totals["a.bwd"]["n"] == 2 and totals["step"]["n"] == 2
    assert totals["step"]["device_ms"] is None


def test_self_time_is_duration_less_children():
    with profiling.recording() as rec:
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.002)
                with profiling.span("leaf"):
                    time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.002)
    spans = {}
    for s in rec.spans:
        spans.setdefault(s.name, []).append(s)
    selfs = rec.self_times()
    outer, leaf = spans["outer"][0], spans["leaf"][0]
    want = (outer.host_end_ns - outer.host_start_ns - sum(
        s.host_end_ns - s.host_start_ns for s in spans["inner"])) / 1e9
    assert selfs["outer"]["host_s"] == pytest.approx(want, abs=1e-9)
    want = sum(s.host_s for s in spans["inner"]) - leaf.host_s
    assert selfs["inner"]["host_s"] == pytest.approx(want, abs=1e-9)
    assert selfs["leaf"]["host_s"] == pytest.approx(leaf.host_s, abs=1e-9)
    assert 0 < selfs["outer"]["host_s"] < outer.host_s


def test_counters_by_innermost_span():
    with profiling.recording() as rec:
        profiling.count("n")
        with profiling.span("a"):
            profiling.count("n", 2)
            with profiling.span("b"):
                profiling.count("n")
                profiling.count("m", 5)
            profiling.count("n")
    assert rec.counts == {"n": {None: 1, "a": 3, "b": 1}, "m": {"b": 5}}


def test_ranges_in_the_chrome_trace_while_recording(tmp_path):
    model, x = Toy(), torch.randn(3, 4)
    with profiling.recording(), profiling.trace(str(tmp_path)):
        profiling.begin_step()
        model(x).sum().backward()
        profiling.backward_done()
    events = json.load(open(tmp_path / os.listdir(tmp_path)[0]))
    names = {e.get("name") for e in events["traceEvents"]}
    for name in ("toy", "a.fwd", "b.fwd", "c.fwd", "c.bwd", "b.bwd",
                 "a.bwd"):
        assert profiling.RANGE + name in names, name


# the spans a training step and a predict record (the tiny GOLF-ss runs
# no CUDA kernel on the CPU)
STEP_SPANS = {"trainer.forward", "trainer.backward", "trainer.optimizer",
              "optimizer.finite_check", "encoder.fwd", "encoder.bwd",
              "encoder.features.fwd", "encoder.pyramid.fwd",
              "encoder.pyramid.bwd", "encoder.lstm.fwd", "encoder.lstm.bwd",
              "encoder.head.fwd", "encoder.head.bwd", "decoder.fwd",
              "decoder.bwd", "loss.fwd", "loss.bwd"}
PREDICT_SPANS = {"predict", "encoder.fwd", "encoder.features.fwd",
                 "encoder.pyramid.fwd", "encoder.lstm.fwd",
                 "encoder.head.fwd", "decoder.fwd"}


def _tiny_run(record: bool, tmp_path):
    """A tiny GOLF-ss: its build, init_state, one Adam step and a predict
    under ``inference_mode``; (loss, gradients, audio, recorder)."""
    from golf_tpu_torch.tasks.ae import build_voice_autoencoder
    from golf_tpu_torch.train.loop import Trainer

    x, f0 = make_inputs(2, 4800, seed=3)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4800)).astype(np.float32))
    ctx = profiling.recording() if record else contextlib.nullcontext()
    with ctx as rec:
        torch.manual_seed(0)
        task = build_voice_autoencoder(tiny_cfg(), device="cpu")
        trainer = Trainer(task, run_dir=str(tmp_path / str(record)))
        trainer.init_state((x, f0))
        xs, f0s = Sig(torch.from_numpy(x), 1), Sig(torch.from_numpy(f0), 1)
        loss = trainer.loss_and_grads(xs, f0s, noise=noise,
                                      random_f0=torch.full((2, 1), 120.0))
        grads = [p.grad.clone() for p in trainer.optimizer.params]
        trainer.optimizer.step()
        task.eval()
        with torch.inference_mode():
            y, _ = task.predict_step(xs, f0s, noise=noise)
    return loss["loss"], grads, y.data, rec


def test_golf_ss_step_and_predict_equal_on_and_off(tmp_path):
    loss0, grads0, y0, _ = _tiny_run(False, tmp_path)
    loss1, grads1, y1, rec = _tiny_run(True, tmp_path)
    assert torch.equal(loss0, loss1)
    assert len(grads0) == len(grads1)
    for a, b in zip(grads0, grads1):
        assert torch.equal(a, b)
    assert torch.equal(y0, y1)
    names = {s.name for s in rec.spans}
    assert {"build.model", "init_running_stats"} <= names
    assert STEP_SPANS <= {s.name for s in rec.spans if s.step == 0}
    assert {s.name for s in rec.spans if s.step == 1} == PREDICT_SPANS
    spans = rec.spans
    for s in spans:
        if s.name.startswith("encoder.") and s.name.endswith(".fwd") \
                and s.name != "encoder.fwd":
            assert spans[s.parent].name == "encoder.fwd", s.name
    enc = [s for s in spans if s.name == "encoder.bwd"][0]
    for s in spans:
        if s.name in ("encoder.pyramid.bwd", "encoder.lstm.bwd",
                      "encoder.head.bwd"):
            assert enc.host_start_ns <= s.host_start_ns
            assert s.host_end_ns <= enc.host_end_ns
    # the optimizer's finite check is the one host sync of the step on the
    # card; the CPU has none to count
    assert "host_syncs" not in rec.counts
