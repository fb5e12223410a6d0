"""The port's model tool twins against golf_tpu's, on the CPU, with the
``cfg/ae/synthetic.yaml`` encoder and the GOLF-ff decoder (golf.yaml),
golf_tpu's seeded variables carried over by ``golf_tpu_torch.bridge`` or
``tools/orbax_to_torch.py``:

* ``tools/rd_stats_torch.py``: its JSON line within 1e-5 relative of
  ``tools/rd_stats.py``'s on the same merged run config and checkpoint
  (measured near 1e-6), its ``--flows-out`` arrays too;
* ``tools/convert_ckpt_torch.py`` after ``tools/orbax_to_torch.py`` equals
  ``tools/orbax_to_torch.py`` after ``tools/convert_ckpt.py`` bit for bit,
  and a permutation then its inverse give the checkpoint back;
* ``tools/time_l2_torch.py`` on golf_tpu's noise field: the loss at
  iteration 0 within 1e-5 relative of ``tools/time_l2.py``'s body, and at
  the offsets golf_tpu's three Adam steps reach. The offsets' gradient is
  held to a float64 run of the port: golf_tpu's own float32 gradient is
  2e-4 of its max-abs from it (a piecewise-linear table lookup, whose
  slope jumps where a rounding moves the phase into another cell), so
  both float32 gradients must lie within 1e-3 of it and of each other.
  The port's Adam loop equals the JAX tool's ``optax.adam`` loop (the best
  offsets kept with the loss before their update) on a smooth objective
  within 1e-7; and its CLI runs on the CPU."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.core.sig import linear_upsample as j_upsample
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.ops.dsp import smooth_phase_offset as j_smooth
from golf_tpu.tasks.ae import build_voice_autoencoder as j_build
from golf_tpu.train.checkpoint import CheckpointManager
from golf_tpu.train.loop import TrainState, make_optimizer
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from golf_tpu_torch.train import checkpoint as ckpt_lib
from tests.test_torch_slice import _batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24000
RD_TOL = 1e-5          # rd_stats' numbers, relative
LOSS_TOL = 1e-5        # time_l2's loss, relative
GRAD_TOL = 1e-3        # time_l2's gradient of max-abs, vs float64 and golf_tpu
ADAM_TOL = 1e-7        # the Adam loop's best loss, relative, and offsets
HOP = 1200             # time_l2's offset hop
LR = 1e-3              # time_l2's default learning rate
OLD_SIZES = [22, 1, 22, 1, 64]
NEW_ORDER = [4, 1, 0, 3, 2]


def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_cfg(loader):
    cfg = loader("cfg/ae/synthetic.yaml")
    dec = loader("cfg/ae/decoder/golf.yaml")
    return {**cfg["model"]["init_args"], "decoder": dec["decoder"]}


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """golf_tpu's task and its init on a batch (as its tools do, running
    min/max included); a merged run config (4 validation items of 0.4 s);
    an orbax checkpoint of every parameter redrawn (normals of 0.3, so the
    select weights spread) and its conversion for the port."""
    tmp = tmp_path_factory.mktemp("tools")
    task = j_build(_model_cfg(j_load_config))
    x, f0 = _batch(2, 0.4)

    def init(x_, f0_):
        return task.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1),
             "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f0_, 1),
            train=True, method=lambda m, *a, **k: m.training_step(*a, **k))

    variables = dict(jax.jit(init)(jnp.asarray(x), jnp.asarray(f0)))
    r = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.3), variables["params"])
    state = TrainState(params, make_optimizer(1e-4, 0.5, "adam").init(params),
                       variables.get("stats", {}),
                       variables.get("batch_stats", {}), 3)
    CheckpointManager(str(tmp / "ckpt")).save_last(state)
    src = str(tmp / "ckpt" / "last")
    port = str(tmp / "port.pt")
    tool("orbax_to_torch").convert(src, port)
    cfg = j_load_config("cfg/ae/synthetic.yaml")
    cfg["model"]["init_args"]["decoder"] = \
        j_load_config("cfg/ae/decoder/golf.yaml")["decoder"]
    cfg["data"]["init_args"].update(n_items=32, duration=0.4, batch_size=2)
    config = tmp / "config.yaml"
    config.write_text(yaml.safe_dump(cfg))
    return dict(task=task, variables=variables, orbax=src, port=port,
                config=str(config), tmp=tmp)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines()[-1]


def _close(got, ref, tol):
    if isinstance(ref, list):
        assert len(got) == len(ref)
        return all(_close(g, r, tol) for g, r in zip(got, ref))
    if isinstance(ref, float):
        return abs(got - ref) <= tol * abs(ref)
    return got == ref


def test_rd_stats_twin_matches_golf_tpu(seeded, monkeypatch):
    tmp = seeded["tmp"]
    argv = ["--config", seeded["config"], "--items", "4"]
    monkeypatch.setattr(sys, "argv", [
        "rd_stats", *argv, "--ckpt", seeded["orbax"], "--flows-out",
        str(tmp / "j.npz")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool("rd_stats").main()
    ref = json.loads(out.getvalue().strip().splitlines()[-1])
    rc, line = _run(tool("rd_stats_torch").main,
                    [*argv, "--ckpt", seeded["port"], "--flows-out",
                     str(tmp / "t.npz"), "--device", "cpu"])
    got = json.loads(line)
    assert rc == 0 and ref["n_voiced_frames"] > 0
    assert ref["rd_std"] > 1e-2          # the select weights spread
    assert got.keys() == ref.keys()
    for key in ref:
        if key == "flows_out":
            continue
        assert _close(got[key], ref[key], RD_TOL), (key, got[key], ref[key])
    j, t = np.load(tmp / "j.npz"), np.load(tmp / "t.npz")
    for key in ("rds", "flows"):
        assert j[key].shape == t[key].shape
        assert np.abs(j[key] - t[key]).max() <= RD_TOL * np.abs(j[key]).max()


def test_convert_ckpt_twin_matches_golf_tpu(seeded, monkeypatch):
    tmp = seeded["tmp"]
    orders = ["--old-sizes", *map(str, OLD_SIZES), "--new-order",
              *map(str, NEW_ORDER)]
    monkeypatch.setattr(sys, "argv", [
        "convert_ckpt", "--in", seeded["orbax"], "--out",
        str(tmp / "j_conv"), *orders])
    with contextlib.redirect_stdout(io.StringIO()):
        tool("convert_ckpt").main()
    tool("orbax_to_torch").convert(str(tmp / "j_conv"), str(tmp / "ref.pt"))
    rc, _ = _run(tool("convert_ckpt_torch").main,
                 ["--in", seeded["port"], "--out", str(tmp / "got.pt"),
                  *orders])
    assert rc == 0
    ref, got = ckpt_lib.load(str(tmp / "ref.pt")), ckpt_lib.load(
        str(tmp / "got.pt"))
    assert got["step"] == ref["step"] == 3
    assert got["model"].keys() == ref["model"].keys()
    moved = [k for k in ref["model"] if "out_linear" in k]
    assert len(moved) == 2
    for k, v in ref["model"].items():
        assert torch.equal(got["model"][k], v), k
    orig = ckpt_lib.load(seeded["port"])["model"]
    assert not torch.equal(got["model"][moved[0]], orig[moved[0]])
    # the inverse permutation gives the checkpoint back
    inverse = list(np.argsort(NEW_ORDER))
    back = tool("convert_ckpt_torch").permute_out_linear(
        got["model"], [OLD_SIZES[i] for i in NEW_ORDER], inverse)
    assert all(torch.equal(back[k], v) for k, v in orig.items())


@pytest.fixture(scope="module")
def time_l2_pair(seeded):
    """golf_tpu's init with its zero-initialised parameters (the head, the
    room filter, the biases) redrawn at 0.01, on both sides; golf_tpu's
    encoding and the body of ``tools/time_l2.py`` (jitted value and
    gradient), and the noise field its key draws."""
    j_task = seeded["task"]
    r = np.random.default_rng(6)
    vs = dict(seeded["variables"])
    vs["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.01) if not np.asarray(a).any() else a,
        vs["params"])
    t_task = t_build(_model_cfg(lambda p: t_load_config([p])), device="cpu")
    load_flax_variables(t_task, jax.tree_util.tree_map(np.asarray, vs))
    t_task.eval().requires_grad_(False)
    x, f0 = _batch(1, 0.4)
    xj, f0j = jnp.asarray(x), jnp.asarray(f0)
    enc = dict(jax.jit(lambda v, a, b: j_task.apply(
        v, JSig(a, 1), JSig(b, 1), False,
        method=lambda m, a_, b_, tr: m.encoder(a_, f0=b_, train=tr)))(
            vs, xj, f0j))
    enc.pop("f0", None)
    enc.pop("voicing_logits", None)
    phase0 = jnp.where(f0j == 0, 150.0, f0j) / SR
    rng = jax.random.key(1)

    def decode(v, e, offsets, **kw):
        up = j_upsample(j_smooth(offsets), HOP)
        t = min(up.shape[1], phase0.shape[1])
        params = dict(e)
        params["phase"] = JSig(phase0[:, :t] + up[:, :t], 1)
        return j_task.apply(v, params, rngs={"noise": rng},
                            method=lambda m, p_: m._decode(p_), **kw)

    def loss_fn(offsets, v, e):
        y = decode(v, e, offsets).data[0]
        t = min(y.shape[0], xj.shape[1])
        return jnp.mean((y[:t] - xj[0, :t]) ** 2)

    zeros = jnp.zeros((1, x.shape[1] // HOP + 2), jnp.float32)
    _, state = jax.jit(lambda v, e, o: decode(
        v, e, o, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
            vs, enc, zeros)
    noise = torch.from_numpy(np.array(
        state["intermediates"]["decoder"]["noise_generator"]["__call__"][0]
        .data))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    return dict(vg=lambda o: vg(o, vs, enc), zeros=zeros, t_task=t_task,
                x=x, f0=f0, noise=noise)


def _objective(pair, dtype=torch.float32):
    tl2 = tool("time_l2_torch")
    task = pair["t_task"]
    if dtype == torch.float64:
        task = t_build(_model_cfg(lambda p: t_load_config([p])),
                       device="cpu")
        task.load_state_dict(pair["t_task"].state_dict())
        task = task.double().eval().requires_grad_(False)
    return tl2, tl2.PhaseOffsetL2(
        task, torch.from_numpy(pair["x"]).to(dtype),
        torch.from_numpy(pair["f0"]).to(dtype), HOP,
        noise=pair["noise"].to(dtype))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_time_l2_loss_and_gradient_match_golf_tpu(time_l2_pair):
    pair = time_l2_pair
    _, obj = _objective(pair)
    loss, grad = obj.loss_and_grad(obj.initial_offsets())
    j_loss, j_grad = pair["vg"](pair["zeros"])
    assert abs(float(loss) - float(j_loss)) <= LOSS_TOL * float(j_loss)
    _, obj64 = _objective(pair, torch.float64)
    loss64, grad64 = obj64.loss_and_grad(obj64.initial_offsets())
    assert abs(float(loss) - float(loss64)) <= LOSS_TOL * float(loss64)
    # the float64 run as the arbiter of both float32 gradients
    assert _rel(grad, grad64) <= GRAD_TOL
    assert _rel(j_grad, grad64) <= GRAD_TOL
    assert _rel(grad, j_grad) <= GRAD_TOL
    # the offsets golf_tpu's three Adam steps reach: the same loss there
    tx = optax.adam(LR)
    offsets, opt_state = pair["zeros"], tx.init(pair["zeros"])
    for _ in range(3):
        _, g = pair["vg"](offsets)
        upd, opt_state = tx.update(g, opt_state, offsets)
        offsets = optax.apply_updates(offsets, upd)
    j_loss3, _ = pair["vg"](offsets)
    with torch.no_grad():
        loss3 = obj.loss(torch.from_numpy(np.array(offsets)))
    assert float(j_loss3) < float(j_loss)
    assert abs(float(loss3) - float(j_loss3)) <= LOSS_TOL * float(j_loss3)


class _Quadratic:
    """A stand-in for ``PhaseOffsetL2`` with a smooth loss, sum w (o -
    c)^2, on which Adam overshoots (the loss falls and rises). On the
    decoder the two packages' float32 gradients part by 4e-4 of max-abs
    (each as far from float64), and Adam's normalised steps carry that into
    the offsets (4e-4 apart after three steps at lr 1e-3), so the loops are
    compared on this objective."""

    def __init__(self):
        r = np.random.default_rng(7)
        self.c = torch.from_numpy(r.normal(0, 0.5, (1, 10)).astype(
            np.float32))
        self.w = torch.from_numpy(r.uniform(0.5, 2.0, (1, 10)).astype(
            np.float32))

    def initial_offsets(self):
        return torch.zeros((1, 10))

    def loss_and_grad(self, offsets):
        d = offsets - self.c
        return torch.sum(self.w * d * d), 2 * self.w * d


def test_time_l2_adam_loop_matches_optax():
    """``optimize`` and the JAX tool's optax loop on the same objective
    keep the same best loss, with the offsets after its update, as
    ``tools/time_l2.py`` keeps them."""
    obj, iters, lr = _Quadratic(), 5, 0.3
    l0, best, best_off = tool("time_l2_torch").optimize(obj, iters, lr)
    offsets = jnp.zeros((1, 10))
    tx = optax.adam(lr)
    opt_state = tx.init(offsets)
    losses = []
    ref_best = None
    for _ in range(iters):
        loss, g = obj.loss_and_grad(torch.from_numpy(np.array(offsets)))
        losses.append(float(loss))
        if ref_best is None:
            ref_best = (float(loss), np.array(offsets))
        upd, opt_state = tx.update(jnp.asarray(g.numpy()), opt_state,
                                   offsets)
        offsets = optax.apply_updates(offsets, upd)
        if float(loss) < ref_best[0]:
            ref_best = (float(loss), np.array(offsets))
    assert any(b > a for a, b in zip(losses, losses[1:]))   # overshoots
    assert l0 == losses[0]
    assert best == pytest.approx(ref_best[0], rel=ADAM_TOL) and best < l0
    assert np.abs(best_off.numpy() - ref_best[1]).max() <= ADAM_TOL


def test_time_l2_cli(seeded, tmp_path):
    cfg = yaml.safe_load(open(seeded["config"]))
    cfg["data"]["init_args"]["duration"] = 0.3
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    rc, line = _run(tool("time_l2_torch").main,
                    ["--config", str(path), "--model",
                     "cfg/ae/decoder/golf.yaml", "--ckpt", seeded["port"],
                     "--iters", "2", "--device", "cpu", "--out",
                     str(tmp_path / "y.wav")])
    report = json.loads(line)
    assert rc == 0 and set(report) == {
        "initial_mse", "final_mse", "initial_l2", "final_l2", "iters",
        "offset_hop", "model", "ckpt"}
    assert report["final_mse"] <= report["initial_mse"]
    # the MSE over the decoded length, at most the item's 7200 samples
    t = report["initial_l2"] / report["initial_mse"]
    assert np.isfinite(report["final_l2"]) and t == round(t) and t <= 7200
    assert (tmp_path / "y.wav").exists()
