"""A configuration of any task of the port's task table is added by new
files and entries alone: the program from ``BUILD_FNS``, and the
reference, the inputs, the spans, the FLOPs count and the faults named by
the configuration's file. A file that names none of them gets the GOLF
autoencoder's parts."""

import json
import shutil
import sys
import time
import types

import pytest
import torch
from torch import nn

from golf_tpu_torch.core.sig import Sig
from golf_tpu_torch.tasks import cli
from golf_tpu_torch.tasks.ae import build_voice_autoencoder
from gpubench.harness import check, faults, inputs, spec
from gpubench.reference import golf

SEED = 2 ** 31 + 4242
CONFIGS = {c["name"]: spec.load_json(spec.ROOT / c["file"]) for c in
           spec.load_json(spec.ROOT / "BENCHMARK.json")["configs"]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_configuration_that_names_no_part_gets_the_autoencoders(name):
    config = CONFIGS[name]
    parts = spec.parts(config)
    assert cli.BUILD_FNS[parts.task] is build_voice_autoencoder
    assert parts.model is config["model"]
    assert spec.reference(config) is golf
    assert (parts.spans, parts.flops) == ("hooks", "flops")
    assert parts.fields == {"noise": {"shape": ["clip"]}}
    assert faults.chosen(config) == list(
        faults.BY_END_FILTER[faults.end_filter(config)])


def test_the_default_fields_are_drawn_as_before():
    """The noise field, then each batch's unvoiced f0, from the noise
    stream: the draws of the harness before fields were named."""
    traffic = {"batch": 2, "seconds": 0.01, "sample_rate": 8000, "pool": 2,
               "random_f0": [50.0, 500.0], "voice": {
                   "knots": 4, "f0_range": [100.0, 300.0],
                   "voiced_above": 0.3, "harmonics": 2, "noise": 0.03,
                   "peak": 0.3}}
    got = inputs.pool(traffic, SEED, "cpu")
    gen = inputs.generator(SEED, "noise", "cpu")
    noise = torch.randn((4, 80), generator=gen)
    for i, batch in enumerate(got):
        assert sorted(batch) == ["f0", "noise", "random_f0", "x"]
        assert torch.equal(batch["noise"], noise[2 * i:2 * i + 2])
        assert torch.equal(batch["random_f0"],
                           50.0 + 450.0 * torch.rand((2, 1), generator=gen))
    short = inputs.pool(dict(traffic, pool=1), SEED, "cpu",
                        {"noise": {"shape": ["clip-1"]}})[0]
    assert short["noise"].shape == (2, 79)
    with pytest.raises(ValueError):
        inputs.field_shape(["frames"], 80)


@pytest.mark.parametrize("names, got, want", [
    (("out_l2", "head_gap"), 1, 1),     # a name with no output
    (("out_l2",), 2, 2),                # an output with no name
    (("out_l2", "head_gap"), 2, 1),     # the reference keeps less
])
def test_numbers_and_outputs_that_differ_in_number_raise(names, got, want):
    """A number left without an output would read 0 and pass any limit."""
    y = torch.ones(2, 3)
    picks = {0: (0, *[y] * got)}
    with pytest.raises(RuntimeError, match="numbers"):
        check.resynth_numbers(picks, {0: (y,) * want}, names)
    assert check.resynth_numbers({0: (0, y)}, {0: (y,)}, ("out_l2",)) == \
        {"out_l2": 0.0}


# -- a toy task: a gain on the input and a scale on a noise field one
# sample shorter, with no encoder, decoder or criterion -------------------

class ToyTask(nn.Module):
    def __init__(self):
        super().__init__()
        self.gain = nn.Parameter(torch.ones(1))
        self.scale = nn.Parameter(torch.ones(1))

    def synth(self, x, noise):
        y = self.gain * x
        return torch.cat([y[:, :1], y[:, 1:] + self.scale * noise], 1)

    def training_step(self, x, f0, train=True, generator=None, noise=None):
        loss = torch.mean((self.synth(x.data, noise) - x.data) ** 2)
        return loss, {"loss": loss}

    def predict_step(self, x, f0, noise=None):
        return Sig(self.synth(x.data, noise), 1), None

    def init_running_stats(self, x, f0):
        pass


def build_toy(model, device=None):
    return ToyTask().to(device)


# the files a change adding the toy's configuration would add
TOY_FILES = {
    "configs/toy.json": {
        "name": "toy", "precision": {"dtype": "float32", "tf32": False},
        "model": {"class_path": "toy_task.ToyTask", "init_args": {}},
        "optimizer": {"optimizer": "adam", "lr": 0.01, "grad_clip": 0.5},
        "reference": "toy", "spans": "program", "flops": "toy_flops",
        "faults": ["toy_faults.half_batch", "toy_faults.altered_answer"],
        "fields": {"noise": {"shape": ["clip-1"]}}},
    "traffic/toy-train.json": {
        "kind": "train", "batch": 4, "seconds": 0.05, "sample_rate": 8000,
        "pool": 3, "first": 3, "warmup": 1, "trace": 2,
        "voice": {"knots": 4, "f0_range": [100.0, 300.0],
                  "voiced_above": 0.3, "harmonics": 3, "noise": 0.03,
                  "peak": 0.3}},
    "traffic/toy-resynth.json": {
        "kind": "resynth", "batch": 4, "seconds": 0.05, "sample_rate": 8000,
        "pool": 3, "warmup": 1, "trace": 2, "check": 2,
        "voice": {"knots": 4, "f0_range": [100.0, 300.0],
                  "voiced_above": 0.3, "harmonics": 3, "noise": 0.03,
                  "peak": 0.3}},
    "limits/toy.train-b4.json": {"loss_gap": {"limit": 1e-5},
                                 "grad_gap": {"limit": 1e-3},
                                 "change_gap": {"limit": 1e-3}},
    "limits/toy.resynth-b4.json": {"out_l2": {"limit": 1e-5}},
    "metrics/toy_forward_ms.train.json": {"reader": "span_ms",
                                          "spans": ["trainer.forward"]},
}
TOY_SOURCES = {
    "reference/toy.py": '''"""The toy task's plain reference."""
import torch

from .golf import Adam

KEEP = ()
NUMBERS = ("out_l2",)


def param_spec(cfg):
    return [("gain", (1,), 0.1, 1.0), ("scale", (1,), 0.1, 0.5)]


def synth(w, b):
    y = w["gain"] * b["x"]
    return torch.cat([y[:, :1], y[:, 1:] + w["scale"] * b["noise"]], 1)


def train_readings(cfg, weights, batches, seeds, device, rows=None,
                   tf32=False):
    names = [n for n, *_ in param_spec(cfg)]
    w = {n: weights[n].clone().requires_grad_(True) for n in names}
    opt = Adam([w[n] for n in names], cfg["optimizer"]["lr"],
               cfg["optimizer"]["grad_clip"])
    losses, grad = [], None
    for k, _ in enumerate(seeds):
        b = {key: v[:rows] for key, v in batches[k % len(batches)].items()}
        loss = torch.mean((synth(w, b) - b["x"]) ** 2)
        used = opt.step(list(torch.autograd.grad(loss, list(w.values()))))
        losses.append(float(loss.detach()))
        if k == 0:
            grad = {n: float(g.norm()) for n, g in zip(names, used)}
    return {"loss": losses, "grad": grad,
            "change": {n: float((w[n].detach() - weights[n]).norm())
                       for n in names}}


def outputs(cfg, weights, first, batches, device, tf32=False):
    return {i: (synth(weights, b),) for i, b in batches.items()}
''',
    "counts/toy_flops.py": '''"""The toy task's FLOPs."""


def train_step(config, batch, t):
    return 6.0 * batch * t


def resynthesis(config, batch, t):
    return 2.0 * batch * t
''',
    "faults/toy_faults.py": '''"""Faults of the toy task."""
import toy_task
from golf_tpu_torch.core.sig import Sig


def half_batch(cuda):
    """The loss of the first half of the batch's rows."""
    orig = toy_task.ToyTask.training_step

    def step(self, x, f0, train=True, generator=None, noise=None):
        n = x.data.shape[0] // 2
        return orig(self, Sig(x.data[:n], 1), Sig(f0.data[:n], 1), train,
                    generator, noise[:n])
    return toy_task.ToyTask, "training_step", step


def altered_answer(cuda):
    """A row given another row's audio."""
    orig = toy_task.ToyTask.predict_step

    def predict(self, x, f0, noise=None):
        y, params = orig(self, x, f0, noise=noise)
        data = y.data.clone()
        data[0] = data[1]
        return Sig(data, y.hop), params
    return toy_task.ToyTask, "predict_step", predict
''',
}
TOY_CELLS = {"toy.train-b4": "toy-train", "toy.resynth-b4": "toy-resynth"}


def with_toy(bench):
    """``bench`` with the toy's configuration, cells and metric added."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "gpubench/configs/toy.json",
                             "reduced": [], "why": "a task of another kind"})
    for cell, traffic in TOY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": traffic, "chips": 1,
                                   "why": "a test"})
    for m in bench["end_to_end"]:
        kind = m["name"].partition("_")[0]
        if "workloads" in m and kind in ("train", "resynth"):
            m["workloads"].append(f"toy.{kind}-b4")
    bench["per_layer"].append({
        "name": "toy_forward_ms.train", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "trainer",
        "moves": "train_audio_s_per_s", "workloads": ["toy.train-b4"]})
    return bench


def without_toy(bench):
    """``bench`` less every entry, and every cell in a metric's list, that
    names the toy."""
    def keep(entry):
        return not entry["name"].startswith("toy")

    out = {k: v for k, v in bench.items()}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] = [dict(e) for e in bench[key] if keep(e)]
        for e in out[key]:
            if "workloads" in e:
                e["workloads"] = [w for w in e["workloads"]
                                  if not w.startswith("toy")]
    return out


@pytest.fixture
def toy_checkout(tmp_path, monkeypatch):
    """A checkout of ``gpubench/`` and ``BENCHMARK.json`` with the toy's
    files and entries added, its ``gpubench`` imported in place of this
    one's, and the toy in the port's task table. Yields (its root, the
    bytes of every file it had before)."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    for rel, data in TOY_FILES.items():
        (root / "gpubench" / rel).write_text(json.dumps(data))
    for rel, text in TOY_SOURCES.items():
        (root / "gpubench" / rel).write_text(text)
    (root / "BENCHMARK.json").write_text(json.dumps(with_toy(
        spec.load_json(spec.ROOT / "BENCHMARK.json"))))
    mod = types.ModuleType("toy_task")
    mod.ToyTask = ToyTask
    monkeypatch.setitem(sys.modules, "toy_task", mod)
    monkeypatch.setitem(cli.BUILD_FNS, "ToyTask", build_toy)
    own = [k for k in sys.modules if k.split(".")[0] == "gpubench"]
    for k in own:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.syspath_prepend(str(root))
    yield root, before
    for k in [k for k in sys.modules if k.split(".")[0] == "gpubench"]:
        del sys.modules[k]


def run(name, traced=False):
    from gpubench.harness import session, spec as copy_spec

    cell = copy_spec.load_cell(name)
    rec, numbers = session.run_cell(cell, SEED, 0.05, traced,
                                    torch.device("cpu"), time.perf_counter(),
                                    least=3)
    return session.result(cell, rec, numbers, traced,
                          {"kind": "cpu", "power_limit_w": None})


def test_a_toy_task_runs_and_is_checked_from_new_files_alone(toy_checkout):
    root, before = toy_checkout
    import gpubench
    from gpubench.harness import faults as copy_faults
    from gpubench.readers import mfu

    assert str(root) in gpubench.__file__
    for name in TOY_CELLS:
        out = run(name)
        assert out["correct"], out["compared"]
        assert out["attempted"] >= 3 and out["failed"] == 0
        assert set(out["metrics"]) >= {"setup_s"} and len(out["metrics"]) > 1
    traced = run("toy.train-b4", traced=True)
    assert traced["correct"]
    assert traced["metrics"]["toy_forward_ms.train"]["value"] > 0
    # the planted faults, as the configuration names them
    config = spec.load_json(root / "gpubench/configs/toy.json")
    half, altered = copy_faults.chosen(config)
    for plant, name, number in ((half, "toy.train-b4", "loss_gap"),
                                (altered, "toy.resynth-b4", "out_l2")):
        with copy_faults.planted(plant, cuda=False):
            out = run(name)
        assert not out["correct"]
        assert out["compared"][number]["value"] > \
            out["compared"][number]["limit"]
    # the FLOPs count, found by the configuration's name
    rec = {"traffic": TOY_FILES["traffic/toy-train.json"],
           "config": config, "trace_steps": 2, "busy_s": 1e-3}
    assert mfu.read(rec) == pytest.approx(
        100 * 2 * 6.0 * 4 * 400 / 1e-3 / 67e12)
    # no file that was there changed; BENCHMARK.json only gained entries
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert without_toy(bench) == json.loads(before[root / "BENCHMARK.json"])
