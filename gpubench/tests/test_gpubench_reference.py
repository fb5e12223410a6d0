"""The plain reference against the port's CPU path at a tiny size, the
check's faults coming out not correct, and (on the card) the TF32 control
coming out not correct."""

import copy
import time

import pytest
import torch

from gpubench.harness import (check, drivers, faults, inputs, program,
                               session, spec)
from gpubench.reference import golf as ref
from golf_tpu_torch.tasks.ae import VoiceAutoEncoder
from golf_tpu_torch.train.loop import ClippedOptimizer

TRAIN = ["golf-ss.train-b64x2s", "golf-ff.train-b64x2s"]
RESYNTH = ["golf-ss.resynth-b64x2s"]
SEED = 2 ** 31 + 12345          # the driver's seeds are large


def tiny(name, batch=2, seconds=0.5):
    """The cell at a size a CPU test holds: the pyramid and LSTM narrowed,
    every other width as configured."""
    cell = copy.deepcopy(spec.load_cell(name))
    enc = cell.config["model"]["encoder_init_args"]
    enc["channels"] = [4, 4, 8, 8]
    enc["lstm_hidden_size"] = 8
    cell.traffic = dict(cell.traffic, batch=batch, seconds=seconds, pool=3,
                        warmup=1)
    return cell


def run(cell, seconds=0.3, least=0):
    rec, numbers = session.run_cell(cell, SEED, seconds, False,
                                    torch.device("cpu"), time.perf_counter(),
                                    least=least)
    return session.result(cell, rec, numbers, False,
                          {"kind": "cpu", "power_limit_w": None})


@pytest.mark.parametrize("name", TRAIN + RESYNTH)
def test_a_sound_run_is_correct(name):
    # a resynthesis window of three batches at least, for a p95
    out = run(tiny(name), least=3 if name in RESYNTH else 1)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m.name for m in spec.load_cell(
        name).end_to_end}


@pytest.mark.parametrize("name", TRAIN)
def test_the_reference_follows_the_port_step_by_step(name):
    cell = tiny(name)
    model = ref.GOLF(cell.config, "cpu")
    weights = inputs.draw_weights(model.param_spec(), SEED, "cpu")
    batches = inputs.pool(cell.traffic, SEED, "cpu")
    prog = program.Training(cell.config, weights, batches[0], "cpu")
    got = drivers.first_steps(prog, batches, SEED, 3, weights)
    want = check.reference_train(cell, weights, batches, SEED, "cpu")
    numbers = check.train_numbers(got, want)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-3
    assert numbers["change_gap"] < 1e-3
    # other dropout masks move the loss far more than the float32 rounding
    other = check.reference_train(cell, weights, batches, SEED + 1, "cpu")
    assert abs(other["loss"][0] - want["loss"][0]) > \
        100 * abs(got["loss"][0] - want["loss"][0])


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    def step(self):
        return {"grad_norm": torch.zeros(()),
                "update_applied": torch.zeros(())}

    monkeypatch.setattr(ClippedOptimizer, "step", step)
    out = run(tiny(TRAIN[0]))
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    orig = VoiceAutoEncoder.training_step

    def half(self, x, f0, *args, noise=None, random_f0=None, **kw):
        n = x.shape[0] // 2
        return orig(self, x[:n], f0[:n], *args, noise=noise[:n],
                    random_f0=random_f0[:n], **kw)

    monkeypatch.setattr(VoiceAutoEncoder, "training_step", half)
    out = run(tiny(name, batch=4))
    assert not out["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_table_cotangent_missing_half_its_blocks_is_not_correct(name):
    """B3b's backward with every other block's share left out: the
    first step's loss is unchanged, the worst leaf's gradient is not."""
    with faults.planted(faults.b3b_half_blocks, cuda=False):
        out = run(tiny(name))
    assert not out["correct"]
    grad = out["compared"]["grad_gap"]
    assert grad["value"] > grad["limit"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    orig = VoiceAutoEncoder.predict_step

    def altered(self, *args, **kw):
        y, params = orig(self, *args, **kw)
        data = y.data.clone()
        data[0] = data[1]
        return type(y)(data, y.hop), params

    monkeypatch.setattr(VoiceAutoEncoder, "predict_step", altered)
    out = run(tiny(RESYNTH[0]))
    assert not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + RESYNTH)
def test_the_tf32_control_is_not_correct(name, cuda_device):
    """The reference in TF32 put in the program's place fails the cell's
    limits, at the full widths on a small batch."""
    cell = copy.deepcopy(spec.load_cell(name))
    cell.traffic = dict(cell.traffic, batch=4, seconds=1.0, pool=3)
    model = ref.GOLF(cell.config, cuda_device)
    weights = inputs.draw_weights(model.param_spec(), SEED, cuda_device)
    batches = inputs.pool(cell.traffic, SEED, cuda_device)
    if cell.traffic["kind"] == "train":
        want = check.reference_train(cell, weights, batches, SEED,
                                     cuda_device)
        tf32 = check.reference_train(cell, weights, batches, SEED,
                                     cuda_device, tf32=True)
        numbers = check.train_numbers(tf32, want)
    else:
        picks = {1: (1, None, None), 2: (2, None, None)}
        want = check.reference_outputs(cell, weights, batches, picks,
                                       cuda_device)
        tf32 = check.reference_outputs(cell, weights, batches, picks,
                                       cuda_device, tf32=True)
        numbers = check.resynth_numbers({k: (k, *tf32[k]) for k in tf32},
                                        want, ref.NUMBERS)
    assert not check.judge(numbers, cell.limits), numbers
