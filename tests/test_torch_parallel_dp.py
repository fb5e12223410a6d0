"""The port's data-parallel training step against golf_tpu's single-device
step, on the CPU.

Ranks are spawned with ``torch.multiprocessing`` on gloo, with a
``file://`` store under ``tmp_path`` (no port to collide on between test
workers), one thread a rank. golf_tpu's references run in the parent (its
jitted step on the tiny GOLF configuration of ``tests/test_seqpar.py``) and
reach the ranks as numpy, its weights through ``bridge``; inputs and the
noise field come from numpy with a seed (the noise captured from golf_tpu's
draw).

* the 2-rank DP step of a tiny GOLF-ss and GOLF-ff: loss within 1e-5
  relative, every gradient within 1e-4 of its largest entry (the conv
  biases in front of a train-mode batch norm, zero in exact arithmetic,
  against their conv weight's gradient, as ``test_torch_train.py`` holds
  them);
* global BatchNorm's running statistics equal on both ranks and equal to
  the single-process run's; ``_split_for_mesh``'s weighting; only rank 0
  writes the metrics and checkpoints.

The rank workers and golf_tpu's reference are shared with
``test_torch_seqpar_ops.py`` and ``test_torch_seqpar_step.py``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(oversampling=4, lpc_order=8, ff=False):
    """``tests/test_seqpar.py``'s ``_tiny_golf_cfg``, and its GOLF-ff
    variant (``test_seqpar_golf_ff_ola_matches``)."""
    cfg = {
        "decoder": {
            "class_path": "models.sf.SourceFilterSynth",
            "init_args": {
                "harm_oscillator": {
                    "class_path":
                        "models.synth.DownsampledIndexedGlottalFlowTable",
                    "init_args": {
                        "hop_rate": 10, "in_channels": 16,
                        "oversampling": oversampling, "equal_energy": True,
                        "table_type": "derivative",
                        "normalize_method": "constant_power",
                        "align_peak": True, "trainable": False,
                        "min_R_d": 0.3, "max_R_d": 2.7, "lf_v2": True,
                        "points": 128, "table_size": 16}},
                "noise_generator": {
                    "class_path": "models.noise.StandardNormalNoise"},
                "noise_filter": {
                    "class_path": "models.filters.LTVZeroPhaseFIRFilter",
                    "init_args": {"window": "hanning", "n_mag": 33}},
                "end_filter": {
                    "class_path":
                        "models.filters.LTVMinimumPhaseFilterPrecise",
                    "init_args": {"lpc_order": lpc_order,
                                  "lpc_parameterisation": "rc2lpc"}},
                "room_filter": {
                    "class_path": "models.filters.LTIAcousticFilter",
                    "init_args": {"length": 32, "conv_method": "fft"}},
                "subtract_harmonics": False,
            }},
        "criterion": {"class_path": "loss.spec.MSSLoss",
                      "init_args": {"n_ffts": [509], "alpha": 1.0,
                                    "window": "hanning"}},
        "encoder_init_args": {
            "f0_min": 60.0, "f0_max": 1000.0,
            "backbone_type": "models.unet.UNetEncoder",
            "n_fft": 256, "hop_length": 240, "channels": [4],
            "strides": [4], "lstm_hidden_size": 16, "num_layers": 1,
            "dropout": 0.0, "learn_voicing": False, "learn_f0": False},
        "sample_rate": 24000,
        "train_with_true_f0": True,
    }
    if ff:
        cfg["decoder"]["init_args"]["end_filter"] = {
            "class_path": "models.filters.LTVMinimumPhaseFilter",
            "init_args": {"lpc_order": lpc_order,
                          "lpc_parameterisation": "rc2lpc",
                          "window": "hanning", "window_length": 960,
                          "centred": True}}
    return cfg


def make_inputs(b, t, seed=0):
    """``tests/test_seqpar.py``'s ``_make_inputs``: x ~ 0.1 N(0, 1), f0
    voiced everywhere (200 +- 40 Hz)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    f0 = (200.0 + 40.0 * np.sin(np.linspace(0, 6.0, t))[None, :]
          * np.ones((b, 1))).astype(np.float32)
    return x, f0


class JaxReference:
    """golf_tpu's single-device training step on the tiny configuration:
    seeded weights (0.1 N(0, 1)), the noise its step draws, and its jitted
    loss and gradients."""

    def __init__(self, cfg, b, t, seed=0, key=7, x=None, f0=None):
        import jax
        import jax.numpy as jnp
        from golf_tpu.core.sig import Sig as JSig
        from golf_tpu.models.noise import StandardNormalNoise as JNoise
        from golf_tpu.tasks.ae import build_voice_autoencoder as j_build

        self.cfg = cfg
        self.x, self.f0 = make_inputs(b, t, seed) if x is None else (x, f0)
        self.task = task = j_build(copy.deepcopy(cfg))
        self.key = jax.random.key(key)
        v = dict(jax.jit(lambda x_, f0_: task.init(
            {"params": jax.random.key(0), "noise": jax.random.key(1),
             "dropout": jax.random.key(2)}, JSig(x_, 1), JSig(f0_, 1), True,
            method=lambda m, *a: m.training_step(*a)))(self.x, self.f0))
        r = np.random.default_rng(5)
        v["params"] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(r.standard_normal(a.shape).astype(
                np.float32) * 0.1), v["params"])
        rngs = {"noise": jax.random.key(key), "dropout": jax.random.key(key)}

        def apply(params, others, **kw):
            return task.apply({**others, "params": params}, JSig(self.x, 1),
                              JSig(self.f0, 1), True, rngs=rngs,
                              method=lambda m, *a: m.training_step(*a), **kw)

        others = {k: w for k, w in v.items() if k != "params"}
        _, state = jax.jit(lambda p: apply(
            p, others, mutable=["intermediates", "stats", "batch_stats"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JNoise)))(
                v["params"])
        self.noise = np.array(state["intermediates"]["decoder"]
                              ["noise_generator"]["__call__"][0].data)
        self.batch_stats = jax.tree_util.tree_map(
            np.asarray, state.get("batch_stats", {}))

        def loss_fn(p):
            (loss, _), _ = apply(p, others,
                                 mutable=["stats", "batch_stats"])
            return loss

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        self.loss = float(loss)
        self.variables = jax.tree_util.tree_map(np.asarray, v)
        from golf_tpu_torch.bridge import flax_to_state_dict
        self.grads = {k: t_.numpy() for k, t_ in flax_to_state_dict(
            {"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def port_task(cfg, variables):
    """The port's task on the CPU with golf_tpu's weights."""
    from golf_tpu_torch.bridge import load_flax_variables
    from golf_tpu_torch.tasks.ae import build_voice_autoencoder
    task = build_voice_autoencoder(copy.deepcopy(cfg), device="cpu")
    load_flax_variables(task, variables)
    task.train()
    return task


def _rank_main(rank, world, store, fn, args, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        queue.put((rank, fn(rank, *args)))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        queue.put((rank, e))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(world, store_dir, fn, *args, timeout=240):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks; returns their
    results by rank (a rank's exception is raised here)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(str(store_dir), f"store{os.getpid()}_{id(fn)}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, out = queue.get(timeout=timeout)
            if isinstance(out, BaseException):
                raise out
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


def dp_worker(rank, cfg, variables, x, f0, noise, run_dir):
    """The Trainer's data-parallel gradients of the global batch (2 ranks),
    then one optimizer step with validation and a checkpoint."""
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.train.loop import Trainer
    task = port_task(cfg, variables)
    trainer = Trainer(task, run_dir=run_dir, lr=1e-3)
    trainer.init_state((x, f0))
    xs, fs = Sig(torch.from_numpy(x), 1), Sig(torch.from_numpy(f0), 1)
    metrics = trainer.loss_and_grads(xs, fs, noise=torch.from_numpy(noise))
    grads = {n: p.grad.numpy().copy() for n, p in task.named_parameters()
             if p.requires_grad}
    stats = {n: b.numpy().copy() for n, b in task.named_buffers()
             if "running_" in n}
    trainer.logger.log(1, {k: float(v) for k, v in metrics.items()})
    trainer._save(float(metrics["loss"]))
    trainer._save(last=True)
    return {"loss": float(metrics["loss"]), "grads": grads, "stats": stats,
            "mesh": trainer.mesh.shape}


def grad_excess(grads, ref, tol, rtol=0.0):
    """Each gradient's worst error over its largest entry, less ``tol`` and
    ``rtol`` times the reference entry over that largest entry (> 0: out of
    the limits); the conv biases in front of a train-mode batch norm against
    their weight's (10 x), as ``test_torch_train.py`` holds them."""
    # the LSTM's bias_ih is frozen at zero in the port (flax has one bias)
    ref, grads = ({k: v for k, v in g.items()
                   if not k.split(".")[-1].startswith("bias_ih")}
                  for g in (ref, grads))
    assert set(grads) == set(ref), set(grads) ^ set(ref)
    out = {}
    for k in sorted(ref):
        scale = np.abs(ref[k]).max()
        if ".pyramid.convs." in k and k.endswith(".bias"):
            scale = 10 * np.abs(ref[k[:-4] + "weight"]).max()
        assert scale > 0, k
        out[k] = float(np.max((np.abs(grads[k] - ref[k])
                               - rtol * np.abs(ref[k])) / scale - tol))
    return out


def check_grads(grads, ref, tol, rtol=0.0):
    """Every gradient within ``tol`` of its largest entry (plus ``rtol`` of
    each entry)."""
    bad = {k: e for k, e in grad_excess(grads, ref, tol, rtol).items()
           if e > 0}
    assert not bad, bad


@pytest.fixture(scope="module", params=["ss", "ff"])
def reference(request):
    cfg = tiny_cfg(4 if request.param == "ss" else 1,
                   ff=request.param == "ff")
    return JaxReference(cfg, 4, 2 * 2400, seed=1, key=3)


def test_dp_step_matches_golf_tpu(reference, tmp_path):
    ref = reference
    out = run_ranks(2, tmp_path, dp_worker, ref.cfg, ref.variables, ref.x,
                    ref.f0, ref.noise, str(tmp_path / "run"))
    assert out[0]["mesh"] == {"data": 2, "time": 1}
    for r in out:
        assert abs(r["loss"] - ref.loss) <= 1e-5 * abs(ref.loss)
        check_grads(r["grads"], ref.grads, 1e-4)
    # global BatchNorm: the same running statistics on both ranks, equal to
    # golf_tpu's after its step on the global batch
    from golf_tpu_torch.bridge import flax_to_state_dict
    j_stats = flax_to_state_dict({"batch_stats": ref.batch_stats})
    for name, v in out[0]["stats"].items():
        np.testing.assert_array_equal(v, out[1]["stats"][name])
        if name in j_stats and "pyramid.norms" in name:
            np.testing.assert_allclose(v, j_stats[name].numpy(), rtol=1e-5,
                                       atol=1e-7)
    # rank 0 alone writes the metrics and the checkpoints
    run = tmp_path / "run"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["step"] == 1
    assert (run / "ckpt" / "last").exists()


def seeded_port_task(cfg):
    from golf_tpu_torch.tasks.ae import build_voice_autoencoder
    torch.manual_seed(0)
    task = build_voice_autoencoder(copy.deepcopy(cfg), device="cpu")
    task.train()
    return task


def split_worker(rank, cfg, x, f0, run_dir):
    """``_split_for_mesh`` of a batch of 5 on 2 data ranks, and the
    validation over it."""
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.train.loop import Trainer
    trainer = Trainer(seeded_port_task(cfg), run_dir=run_dir)
    trainer.init_state((x[:4], f0[:4]))
    chunks = [(tuple(xc.shape), shard is not None, w)
              for xc, _, shard, w in trainer._split_for_mesh(
                  Sig(torch.from_numpy(x), 1), Sig(torch.from_numpy(f0), 1))]
    return {"chunks": chunks, "val": trainer.validate([(x, f0)])}


def test_split_for_mesh_weights_chunks(tmp_path):
    """A batch of 5 on 2 data ranks: a chunk of 4 evaluated data-parallel
    (2 rows a rank) and one of 1 evaluated whole on each rank; the
    validation is their size-weighted mean, which the single process
    reproduces by evaluating the two chunks in turn with the same
    generator (within 1e-5 relative)."""
    cfg = tiny_cfg(1)
    x, f0 = make_inputs(5, 2 * 2400, seed=4)
    out = run_ranks(2, tmp_path, split_worker, cfg, x, f0,
                    str(tmp_path / "run"))
    assert out[0]["chunks"] == [((2, x.shape[1]), True, 4),
                                ((1, x.shape[1]), False, 1)]
    assert out[0]["val"] == out[1]["val"]
    from golf_tpu_torch.core.sig import Sig
    from golf_tpu_torch.train.loop import Trainer
    trainer = Trainer(seeded_port_task(cfg), run_dir=str(tmp_path / "one"))
    trainer.init_state((x[:4], f0[:4]))
    task = trainer.task.eval()
    gen = torch.Generator().manual_seed(trainer.seed + 999)
    parts = []
    with torch.no_grad():
        for rows in (slice(0, 4), slice(4, 5)):
            parts.append(task.validation_step(
                Sig(torch.from_numpy(x[rows]), 1),
                Sig(torch.from_numpy(f0[rows]), 1), generator=gen))
    for k, v in out[0]["val"].items():
        want = (4 * float(parts[0][k[4:]]) + float(parts[1][k[4:]])) / 5
        assert abs(v - want) <= 1e-5 * abs(want), (k, v, want)


def sharded_worker(rank, cfg, variables, x, f0, noise, layouts,
                   pad_align=None):
    """``make_sharded_train_step`` on each (data, time) layout of
    ``layouts`` over the leading ranks (the others sit a layout out);
    rank 0's (loss, grads) by layout."""
    from golf_tpu_torch.parallel.mesh import make_mesh
    from golf_tpu_torch.parallel.seqpar import make_sharded_train_step
    out = []
    for data, time in layouts:
        mesh = make_mesh(data, time)
        if not mesh.member:
            out.append(None)
            continue
        task = port_task(cfg, variables)
        step = make_sharded_train_step(task, mesh, pad_align=pad_align)
        loss, grads, _ = step(torch.from_numpy(x), torch.from_numpy(f0),
                              noise=torch.from_numpy(noise))
        out.append((loss, {k: g.numpy() for k, g in grads.items()}))
    return out


def many_sharded_worker(rank, jobs, layouts):
    """``sharded_worker`` on each (cfg, variables, x, f0, noise) of
    ``jobs`` in turn: its results by job."""
    return [sharded_worker(rank, *job, layouts) for job in jobs]


def test_cli_fit_under_torchrun_on_gloo(tmp_path):
    """``autoencode_torch.py fit`` under ``torchrun --nproc_per_node=2`` on
    the CPU (gloo, ``--standalone`` rendezvous on a free local port): both
    ranks train 2 steps data-parallel at B = 2 (one row each); rank 0 alone
    writes the config, the metrics (one validation line) and the
    checkpoints, and prints."""
    import subprocess
    import sys
    run_dir = tmp_path / "run"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", os.path.join(ROOT, "autoencode_torch.py"),
         "fit", "--config", "cfg/ae/synthetic.yaml", "--model",
         "cfg/ae/decoder/golf.yaml", "--device", "cpu",
         "data.init_args.n_items=4", "data.init_args.duration=0.3",
         "data.init_args.batch_size=2", "trainer.max_steps=2",
         "--run_dir", str(run_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (run_dir / "config.yaml").exists()
    assert (run_dir / "ckpt" / "last").exists()
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "val_loss" in r] == [2]
    assert out.stdout.count("[val @ 2]") == 1
