"""GOLF-fs and the sample-wise SGD finetune of the port against golf_tpu, on
the CPU.

* ``convert2samplewise`` gives golf_tpu's tree for every decoder config,
  up to the package prefix of the class paths it writes;
* ``LTVZeroPhaseFIRFilterPrecise`` within 1e-5 of max|y| of golf_tpu's
  (fp32, the same einsum over the same upsampled kernels);
* GOLF-fs ``predict_step`` (``golf.yaml`` through ``convert2samplewise``,
  the ``cfg/ae/synthetic.yaml`` encoder) from bridged weights within 1e-4
  of max|y| of golf_tpu's;
* ``ClippedOptimizer`` against golf_tpu's ``make_optimizer`` (optax):
  adam, adamw, sgd and amsgrad, each with and without ``lr_decay``, three
  applied steps around one non-finite gradient, within 1e-6 of max|param|
  (fp32 updates in another operation order);
* the CLI's optimizer arguments against golf_tpu's ``build_from_config``;
* a params-only restore of a GOLF-ff checkpoint into the GOLF-ss model of
  ``golf-precise-stable.yaml``, strict on the keys;
* the CLI: ``fit`` of ``cfg/ae/vctk.yaml`` from a VCTK tree, then GOLF-fs
  ``test`` and a params-only SGD finetune from its checkpoint, on
  ``--device cpu``.
"""

import contextlib
import copy
import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from golf_tpu.config.registry import convert2samplewise as j_convert
from golf_tpu.config.registry import load_config as j_load_config
from golf_tpu.core.sig import Sig as JSig
from golf_tpu.models.filters import \
    LTVZeroPhaseFIRFilterPrecise as JPrecise
from golf_tpu.models.noise import StandardNormalNoise as JNoise
from golf_tpu.tasks.ae import build_voice_autoencoder as j_build
from golf_tpu.tasks.cli import build_from_config
from golf_tpu.tasks.data import SyntheticVoiceDataset
from golf_tpu.train.loop import make_optimizer
from golf_tpu_torch.bridge import load_flax_variables
from golf_tpu_torch.config.registry import convert2samplewise as t_convert
from golf_tpu_torch.config.registry import load_config as t_load_config
from golf_tpu_torch.core.sig import Sig as TSig
from golf_tpu_torch.models.filters import \
    LTVZeroPhaseFIRFilterPrecise as TPrecise
from golf_tpu_torch.tasks.ae import build_voice_autoencoder as t_build
from golf_tpu_torch.tasks.cli import trainer_kwargs
from golf_tpu_torch.train import checkpoint as ckpt_lib
from golf_tpu_torch.train.loop import (OPTIMIZERS, ClippedOptimizer,
                                       Trainer)
from golf_tpu_torch.utils.wav import write_wav

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODERS = sorted(os.path.basename(p)[:-5] for p in
                  glob.glob(os.path.join(ROOT, "cfg/ae/decoder/*.yaml")))


def _strip_prefix(tree):
    if isinstance(tree, dict):
        return {k: _strip_prefix(v) for k, v in tree.items()}
    if isinstance(tree, str) and tree.startswith("golf_tpu_torch."):
        return "golf_tpu." + tree[len("golf_tpu_torch."):]
    return tree


@pytest.mark.parametrize("decoder", DECODERS)
def test_convert2samplewise_matches_golf_tpu(decoder):
    cfg = j_load_config(f"cfg/ae/decoder/{decoder}.yaml")
    ref = j_convert(copy.deepcopy(cfg))
    got = t_convert(copy.deepcopy(cfg))
    assert _strip_prefix(got) == ref


def test_convert2samplewise_builds_the_port_decoder():
    cfg = t_convert(t_load_config(["cfg/ae/decoder/golf.yaml"]))
    dec = cfg["decoder"]["init_args"]
    assert dec["end_filter"]["class_path"] == \
        "golf_tpu_torch.models.filters.LTVMinimumPhaseFilterPrecise"
    assert dec["noise_filter"]["class_path"] == \
        "golf_tpu_torch.models.filters.LTVZeroPhaseFIRFilterPrecise"
    base = t_load_config(["cfg/ae/synthetic.yaml"])["model"]["init_args"]
    task = t_build({**base, "decoder": cfg["decoder"]}, device="cpu")
    assert isinstance(task.decoder.noise_filter, TPrecise)
    ref = j_build({**j_load_config("cfg/ae/synthetic.yaml")["model"]
                   ["init_args"], "decoder": j_convert(j_load_config(
                       "cfg/ae/decoder/golf.yaml"))["decoder"]})
    assert task.decoder.param_layout == ref.decoder.param_layout


@pytest.mark.parametrize("n_mag,hop,t", [(33, 240, 4800), (129, 120, 3000),
                                         (256, 240, 2400)])
def test_precise_zero_phase_fir_matches_golf_tpu(n_mag, hop, t):
    r = np.random.default_rng(n_mag)
    frames = t // hop + 1
    ex = r.standard_normal((2, t)).astype(np.float32)
    log_mag = (r.standard_normal((2, frames, n_mag)) * 0.5 - 1.0
               ).astype(np.float32)
    ref = np.asarray(JPrecise(window="hanning", n_mag=n_mag).apply(
        {}, JSig(jnp.asarray(ex), 1), JSig(jnp.asarray(log_mag), hop)).data)
    out = TPrecise(window="hanning", n_mag=n_mag)(
        TSig(torch.from_numpy(ex), 1),
        TSig(torch.from_numpy(log_mag), hop)).data.numpy()
    assert out.shape == ref.shape
    # fp32: the same upsampled kernels and products, summed in another
    # order (XLA's dot against torch's bmm)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def _model_cfg(loader, convert):
    cfg = loader("cfg/ae/synthetic.yaml")
    dec = convert(loader("cfg/ae/decoder/golf.yaml"))
    return {**cfg["model"]["init_args"], "decoder": dec["decoder"]}


def test_golf_fs_predict_step_matches_golf_tpu():
    """GOLF-fs: golf.yaml through convert2samplewise, weights from
    golf_tpu through the bridge, same batch and noise: within 1e-4 of
    max|y| (fp32 through the BiLSTM, two FFT libraries and the blocked
    all-pole forms; the measured error is about 5e-5)."""
    ds = SyntheticVoiceDataset(2, 0.5, 24000, seed=3)
    x = np.stack([ds[i][0] for i in range(2)])
    f0 = np.stack([ds[i][1] for i in range(2)])
    x = (x + 0.03 * np.random.default_rng(11).standard_normal(x.shape)
         ).astype(np.float32)
    task = j_build(_model_cfg(j_load_config, j_convert))

    def init(x_, f0_):
        phase = JSig(jnp.where(f0_ == 0, 150.0, f0_) / 24000.0, 1)
        return task.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1),
             "dropout": jax.random.key(2)},
            JSig(x_, 1), JSig(f0_, 1), {"phase": phase}, True)

    variables = dict(jax.jit(init)(jnp.asarray(x), jnp.asarray(f0)))
    r = np.random.default_rng(5)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                              * 0.1), variables["params"])
    (y, _), state = jax.jit(lambda v, x_, f0_: task.apply(
        v, JSig(x_, 1), JSig(f0_, 1), rngs={"noise": jax.random.key(3)},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise),
        method=lambda m, *a: m.predict_step(*a)))(
            variables, jnp.asarray(x), jnp.asarray(f0))
    noise = np.array(state["intermediates"]["decoder"]["noise_generator"]
                     ["__call__"][0].data)
    t_task = t_build(_model_cfg(lambda p: t_load_config([p]), t_convert),
                     device="cpu")
    load_flax_variables(t_task, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    t_task.eval()
    with torch.inference_mode():
        out, _ = t_task.predict_step(TSig(torch.from_numpy(x), 1),
                                     TSig(torch.from_numpy(f0), 1),
                                     noise=torch.from_numpy(noise))
    ref = np.asarray(y.data)
    assert out.shape == ref.shape and np.abs(ref).max() > 0
    err = np.abs(out.data.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("lr_decay", [None, 0.5])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_optimizer_matches_optax(optimizer, lr_decay):
    """Three applied steps, the non-finite gradient between the first and
    the second skipped (neither the moments nor the schedule's count
    advance); the gradients' scales fall from step to step, so amsgrad's
    max differs from adam's moment, and the first is clipped."""
    r = np.random.default_rng(1)
    shapes = [(3, 4), (5,)]
    p0 = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[r.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (3.0, 0.05, 0.01)]
    grads.insert(1, [np.full(s, np.inf, np.float32) for s in shapes])
    tx = make_optimizer(lr=0.01, grad_clip=0.5, optimizer=optimizer,
                        lr_decay=lr_decay)
    params_j = [jnp.asarray(p) for p in p0]
    state = tx.init(params_j)
    params_t = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ClippedOptimizer(params_t, lr=0.01, grad_clip=0.5,
                           optimizer=optimizer, lr_decay=lr_decay)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        for p, a in zip(params_t, g):
            p.grad = torch.from_numpy(a.copy())
        info = opt.step()
        assert bool(info["update_applied"]) == bool(np.isfinite(g[0]).all())
        scale = max(np.abs(np.asarray(q)).max() for q in params_j)
        for p, q in zip(params_t, params_j):
            assert np.abs(p.detach().numpy() - np.asarray(q)).max() <= \
                1e-6 * scale
    assert opt.count == 3
    moved = max(np.abs(p.detach().numpy() - q).max()
                for p, q in zip(params_t, p0))
    assert moved > 1e-4


def test_optimizer_state_round_trip_and_refuses_another():
    p = torch.nn.Parameter(torch.ones(3))
    opt = ClippedOptimizer([p], lr=0.1, optimizer="amsgrad")
    p.grad = torch.full((3,), 0.2)
    opt.step()
    state = copy.deepcopy(opt.state_dict())
    q = torch.nn.Parameter(p.detach().clone())
    twin = ClippedOptimizer([q], lr=0.1, optimizer="amsgrad")
    twin.load_state_dict(state)
    p.grad = torch.full((3,), -0.1)
    q.grad = torch.full((3,), -0.1)
    opt.step()
    twin.step()
    assert torch.equal(p, q)
    with pytest.raises(ValueError, match="params-only"):
        ClippedOptimizer([q], optimizer="sgd").load_state_dict(state)
    with pytest.raises(ValueError):
        ClippedOptimizer([q], optimizer="rmsprop")


@pytest.mark.parametrize("optimizer_node,scheduler,want", [
    ({"class_path": "torch.optim.SGD", "init_args": {"lr": 1e-5}}, None,
     "sgd"),
    ({"class_path": "torch.optim.AdamW", "init_args": {"lr": 3e-4}}, None,
     "adamw"),
    ({"class_path": "torch.optim.Adam",
      "init_args": {"lr": 1e-3, "amsgrad": True}}, {"decay": 2e-5},
     "amsgrad"),
    ({"class_path": "torch.optim.RMSprop", "init_args": {"lr": 1e-3}},
     None, "adam"),
    (None, None, "adam")])
def test_trainer_kwargs_match_golf_tpu(optimizer_node, scheduler, want):
    cfg = j_load_config("cfg/ae/synthetic.yaml")
    cfg["model"]["init_args"]["decoder"] = j_load_config(
        "cfg/ae/decoder/golf.yaml")["decoder"]
    if optimizer_node is None:
        cfg.pop("optimizer")
    else:
        cfg["optimizer"] = optimizer_node
    if scheduler is not None:
        cfg["lr_scheduler"] = scheduler
    _, _, ref = build_from_config(copy.deepcopy(cfg))
    got = trainer_kwargs(cfg)
    assert got["optimizer"] == ref["optimizer"] == want
    for key in ("lr", "lr_decay", "grad_clip", "max_steps",
                "val_every_steps", "restore_params_only", "seed"):
        assert got[key] == ref[key], key


def _task(decoder):
    cfg = t_load_config(["cfg/ae/synthetic.yaml"],
                        f"cfg/ae/decoder/{decoder}.yaml")
    torch.manual_seed(0)
    return t_build(cfg["model"]["init_args"], device="cpu")


def test_golf_ff_checkpoint_restores_params_only_into_golf_ss(tmp_path):
    """The finetune's restore: GOLF-ff's model state into the capped GOLF-ss
    model, every key matched (strict), a fresh SGD state at step 0; a key
    the model lacks, or a key it has and the checkpoint lacks, raises."""
    ff = _task("golf")
    with torch.no_grad():
        for p in ff.parameters():
            p.add_(0.01)
    path = str(tmp_path / "ff.pt")
    torch.save({"model": ff.state_dict(), "optimizer": {}, "step": 40},
               path)
    ss = _task("golf-precise-stable")
    assert ss.decoder.end_filter.max_abs_value == 0.98
    trainer = Trainer(ss, run_dir=str(tmp_path / "run"), optimizer="sgd",
                      lr=1e-5)
    trainer.restore(path, params_only=True)
    assert trainer.step == 0 and trainer.optimizer.count == 0
    for k, v in ff.state_dict().items():
        assert torch.equal(ss.state_dict()[k], v), k
    extra = dict(ff.state_dict(), **{"decoder.extra": torch.zeros(1)})
    missing = dict(ff.state_dict())
    missing.pop("decoder.room_filter.kernel")
    for sd in (extra, missing):
        torch.save({"model": sd, "step": 1}, path)
        with pytest.raises(RuntimeError, match="decoder"):
            ckpt_lib.restore_params_into(path, ss)


def _vctk_tree(root, sr=24000):
    """Train speakers p300 and p301, valid p225, test p360: 0.8 s files of
    the synthetic voice with their 5 ms f0 tracks."""
    ds = SyntheticVoiceDataset(6, 0.8, sr, seed=4)
    for i, (spk, k) in enumerate((("p300", 0), ("p300", 1), ("p301", 0),
                                  ("p301", 1), ("p225", 0), ("p360", 0))):
        x, f0 = ds[i]
        d = root / spk
        d.mkdir(exist_ok=True)
        path = d / f"{spk}_{k:03d}_mic1.wav"
        write_wav(str(path), x, sr)
        hop = int(0.005 * sr)
        np.savetxt(str(path.with_suffix(".pv")),
                   f0[np.minimum(np.arange(len(x) // hop + 1) * hop,
                                 len(x) - 1)])


def test_cli_fit_from_vctk_then_golf_fs_and_sgd_finetune(tmp_path):
    """``fit --config cfg/ae/vctk.yaml`` builds ``VCTK`` from a tree and
    trains two Adam steps; GOLF-fs ``test`` runs on its checkpoint; a
    params-only finetune on ``golf-precise-stable.yaml`` takes two SGD
    steps at lr 1e-5 with ``coef_smooth_weight`` 0.1 (the recipe's flags)
    from it."""
    from golf_tpu_torch.tasks.cli import run
    tree = tmp_path / "vctk"
    tree.mkdir()
    _vctk_tree(tree)
    data = [f"data.init_args.wav_dir={tree}", "data.init_args.batch_size=2",
            "data.init_args.duration=0.5", "data.init_args.overlap=0.25"]
    base = ["--config", "cfg/ae/vctk.yaml", "--device", "cpu", *data,
            "model.init_args.encoder_init_args.num_layers=1"]
    ff_dir = tmp_path / "ff"
    assert run(["fit", *base, "--model", "cfg/ae/decoder/golf.yaml",
                "--run_dir", str(ff_dir), "trainer.max_steps=2"]) == 0
    ckpt = str(ff_dir / "ckpt" / "last")
    assert ckpt_lib.load(ckpt)["step"] == 2

    fs_model = tmp_path / "golf-fs.yaml"
    with open(fs_model, "w") as f:
        yaml.safe_dump(t_convert(t_load_config(["cfg/ae/decoder/golf.yaml"])),
                       f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(["test", *base, "--model", str(fs_model), "--run_dir",
                    str(tmp_path / "fs"), "--ckpt_path", ckpt]) == 0
    fs = json.loads(out.getvalue().strip().splitlines()[-1])
    assert np.isfinite(fs["avg_mss_loss"]) and np.isfinite(fs["avg_mcd"])

    ss_dir = tmp_path / "ss"
    assert run(["fit", *base, "--model",
                "cfg/ae/decoder/golf-precise-stable.yaml", "--run_dir",
                str(ss_dir), "trainer.max_steps=2",
                "optimizer.class_path=torch.optim.SGD",
                "optimizer.init_args.lr=0.00001",
                "model.init_args.coef_smooth_weight=0.1",
                "ckpt_params_only=true", f"ckpt_path={ckpt}"]) == 0
    state = ckpt_lib.load(str(ss_dir / "ckpt" / "last"))
    assert state["step"] == 2 and state["optimizer"]["optimizer"] == "sgd"
    assert state["optimizer"]["count"] == 2
    ff_state = ckpt_lib.load(ckpt)["model"]
    # two SGD steps of lr 1e-5 under the 0.5 clip move a weight by at most
    # 1e-5: the finetune started from the GOLF-ff weights
    for k, v in ff_state.items():
        if v.is_floating_point() and "running" not in k and \
                "log_spec" not in k:
            assert (state["model"][k] - v).abs().max().item() <= 1e-5, k
    recs = [json.loads(ln) for ln in open(ss_dir / "metrics.jsonl")]
    assert np.isfinite([r["val_loss"] for r in recs if "val_loss" in r]
                       ).all()
