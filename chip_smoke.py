#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (golf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. environment: versions, the card's name and power limit; TF32 off (for
   every phase, the train phase's step times included);
2. build: the five CUDA kernels of the serving and training paths (four
   sources, one ``nvcc`` each, started together), from
   ``golf_tpu_torch/kernels/csrc``;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   serving path (B1, B2, B4) and the training path (all five) give them,
   with each one's time, its plain version's time and its roofline bound;
   then each autograd Function's backward through the kernels against the
   same Function on the plain versions, on the same cotangent;
4. serve: the full-width Interspeech24 autoencoder (the encoder of
   ``cfg/ae/vctk.yaml``) with the GOLF-ff decoder (``golf.yaml``), then the
   GOLF-ss decoder (``golf-precise.yaml``), seeded random weights, answers
   4 synthetic 6 s requests batched as B = 4; each kernel's launch count
   must move; one 2 s request is held against the port's own CPU run;
5. train: the same two models take 3 Adam steps each through the port's
   ``Trainer`` on B = 64 synthetic items of 2 s; every loss must be finite
   and B3a, B3b and B2 (GOLF-ff) or B4 (GOLF-ss) must launch; one step at
   B = 2 x 1 s (dropout 0, train mode) is held against the port's CPU run,
   loss and every gradient;
6. summary: a ``kernels:`` line, the card, then one JSON line with the
   kernel table;
7. last line: ``{"ok": true, "device": {...}}``.

Needs one CUDA device, and exits non-zero without one. Imports torch and
golf_tpu_torch only.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from golf_tpu_torch import kernels
from golf_tpu_torch.core.sig import Sig, linear_upsample
from golf_tpu_torch.ops import lookup as lk
from golf_tpu_torch.ops.allpole import (allpole, allpole_const,
                                        allpole_const_cuda,
                                        allpole_const_plain, allpole_cuda,
                                        allpole_plain)
from golf_tpu_torch.ops.dsp import rc2lpc
from golf_tpu_torch.tasks.ae import VoiceAutoEncoder, build_voice_autoencoder
from golf_tpu_torch.tasks.data import SyntheticVoiceDataset
from golf_tpu_torch.train.loop import Trainer, trainable_parameters

SEED = 0
SR = 24000
BATCH = 4
SECONDS = 6.0
CHECK_SECONDS = 2.0
TRAIN_BATCH = 64            # cfg/ae/vctk.yaml: batch 64 of 2 s segments
TRAIN_SECONDS = 2.0
TRAIN_STEPS = 3
TRAIN_CHECK_BATCH = 2       # the card-vs-CPU training step
TRAIN_CHECK_SECONDS = 1.0
TRAIN_GRAD_TOL = 1e-3       # of each gradient's largest entry
PYRAMID_GRAD_TOL = 2e-2     # the encoder's conv pyramid (phase_train_vs_cpu)
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# ---------------------------------------------------------------------------
# Model configuration: cfg/ae/vctk.yaml's model.init_args with the decoder
# of cfg/ae/decoder/golf.yaml or golf-precise.yaml (interpolations resolved)
# ---------------------------------------------------------------------------

_ENCODER = {
    "f0_min": 60.0, "f0_max": 1000.0,
    "backbone_type": "models.unet.UNetEncoder",
    "n_fft": 1024, "hop_length": 240,
    "channels": [32, 64, 128, 256], "strides": [4, 4, 4, 4],
    "lstm_hidden_size": 256, "num_layers": 3, "dropout": 0.1,
    "learn_voicing": False, "learn_f0": False,
}
_MODEL = {
    "encoder_class_path": "models.enc.VocoderParameterEncoderInterface",
    "encoder_init_args": _ENCODER,
    "decoder": None,
    "criterion": {"class_path": "loss.spec.MSSLoss",
                  "init_args": {"n_ffts": [509, 1021, 2053], "alpha": 1.0,
                                "window": "hanning", "center": True}},
    "sample_rate": 24000,
    "voicing_loss_weight": 1.0, "f0_loss_weight": 1.0,
    "detach_voicing": True, "detach_f0": True, "train_with_true_f0": True,
}
_HARM = {
    "class_path": "models.synth.DownsampledIndexedGlottalFlowTable",
    "init_args": {"hop_rate": 10, "in_channels": 64, "oversampling": 4,
                  "equal_energy": True, "table_type": "derivative",
                  "normalize_method": "constant_power", "align_peak": True,
                  "trainable": False, "min_R_d": 0.3, "max_R_d": 2.7,
                  "lf_v2": True, "points": 2048},
}
_END_FILTERS = {
    "golf": {"class_path": "models.filters.LTVMinimumPhaseFilter",
             "init_args": {"window": "hanning", "window_length": 960,
                           "lpc_order": 22,
                           "lpc_parameterisation": "rc2lpc"}},
    "golf-precise": {"class_path":
                     "models.filters.LTVMinimumPhaseFilterPrecise",
                     "init_args": {"lpc_order": 22,
                                   "lpc_parameterisation": "rc2lpc"}},
}


def model_config(decoder: str) -> dict:
    """model.init_args for ``cfg/ae/vctk.yaml`` + ``cfg/ae/decoder/<decoder>
    .yaml``."""
    cfg = copy.deepcopy(_MODEL)
    cfg["decoder"] = {
        "class_path": "models.sf.SourceFilterSynth",
        "init_args": {
            "harm_oscillator": copy.deepcopy(_HARM),
            "noise_generator": {
                "class_path": "models.noise.StandardNormalNoise"},
            "noise_filter": {"class_path":
                             "models.filters.LTVZeroPhaseFIRFilter",
                             "init_args": {"window": "hanning",
                                           "n_mag": 256}},
            "end_filter": copy.deepcopy(_END_FILTERS[decoder]),
            "room_filter": {"class_path": "models.filters.LTIAcousticFilter",
                            "init_args": {"length": 128,
                                          "conv_method": "fft"}},
            "subtract_harmonics": False,
        }}
    return cfg


def main_path_shapes(batch: int, t: int) -> dict:
    """Operand shapes each kernel gets from the serving or training path for
    ``batch`` clips of ``t`` samples at the vctk widths (hop 240, 4x
    oversampling, table hop 10 frames, 960-sample GOLF-ff windows, order
    22). B3b's second shape is that of the table cotangent it returns."""
    hop, os_, p = 240, 4, 22
    frames = -(-t // hop)                      # f0 frames (spectrogram: +1)
    table_rows = (frames + 2 * 5 - 10) // 10 + 1
    t_os = (t - 1) * os_ + 1
    hop_os = hop * 10 * os_
    blocks = -(-t_os // hop_os)
    # the noise filter's frame-wise output is (frames - 1) * hop samples
    t_src = min(t, (frames - 1) * hop)
    t_ss = min(t_src, (frames - 1) * hop + 1)
    n_ff = batch * min((t_ss + 960 - 960) // hop + 1, frames)
    lookup = ((batch, blocks, hop_os), (batch, table_rows, 2048))
    return {
        "lookup": lookup,
        "lookup_res": lookup,
        "lookup_dtab": lookup,
        "allpole_const": ((n_ff, 960), (n_ff, p)),
        "allpole_tv": ((batch, t_ss), (batch, t_ss, p)),
    }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond, measured."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(stop)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps``
    calls. A short kernel launches faster on the device than the host can
    issue it, so the stream is first held busy (``torch.cuda._sleep``) for
    longer than the host takes to enqueue the ``reps`` calls: the events
    then time the device's back-to-back work, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_ms * _sleep_cycles_per_ms()) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float):
    """Roofline bound in ms and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lpc_coeffs(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Coefficients as the model makes them: rc2lpc(tanh(logits)). The
    logits' scale (0.2) keeps the plain version's blocked two-pass form
    accurate: its error grows with the filter's gain (about 1e-6 of max|y|
    here, a few percent at a scale of 0.5, on the CPU in fp32)."""
    logits = 0.2 * torch.randn(shape, generator=gen, device=device)
    return rc2lpc(torch.tanh(logits)).contiguous()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN (parity phases compare fp32)")
    return card


def phase_build() -> None:
    log: dict = {}
    seconds = kernels.build(kernels.ALL, log)
    print(f"build: {seconds:.1f} s for {len(kernels.ALL)} kernels "
          f"({', '.join(k.source for k in kernels.ALL)})")
    for name, out in log.items():
        usage = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in usage:
            print(f"  ptxas[{name}]: {ln}")


def lookup_inputs(gen, shapes):
    (b, blocks, hop), tab_shape = shapes["lookup"]
    ph = torch.rand((b, blocks, hop), generator=gen, device="cuda")
    tables = torch.randn(tab_shape, generator=gen, device="cuda")
    return ph, tables, hop


def allpole_tv_inputs(gen, shapes):
    """x and sample-rate coefficients upsampled from frames, as the GOLF-ss
    filter makes them."""
    x_shape, a_shape = shapes["allpole_tv"]
    bsz, t = x_shape
    frames = -(-t // 240) + 1
    x = torch.randn(x_shape, generator=gen, device="cuda")
    a_frames = lpc_coeffs(gen, (bsz, frames, a_shape[2]), "cuda")
    a = linear_upsample(a_frames, 240, axis=1)[:, :t].contiguous()
    return x, a


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def phase_kernels(shapes: dict, which=("lookup", "allpole_const",
                                       "allpole_tv"), label="serve") -> dict:
    """Each kernel against its plain version on the same inputs, with its
    time, the plain version's time and the roofline bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    ph, tables, hop = lookup_inputs(gen, shapes)
    n_el = ph.numel()
    if "lookup" in which:
        out = lk.lookup_blocks_cuda(ph, tables, hop)
        err = (out - lk.lookup_blocks_plain(ph, tables, hop)).abs().max()
        err = err.item()
        print(f"[{label}] lookup (B1) {tuple(ph.shape)} x "
              f"{tuple(tables.shape)}: max abs err {err:.3e} "
              f"(tolerance 2e-6)")
        check(err <= 2e-6, "lookup vs plain")
        rows["lookup"] = dict(
            err=err, ms=cuda_ms(lambda: lk.lookup_blocks_cuda(ph, tables,
                                                              hop), 100),
            plain_ms=cuda_ms(lambda: lk.lookup_blocks_plain(ph, tables, hop),
                             10),
            bound=bound(4 * (2 * n_el + tables.numel()), 15 * n_el))
    if "lookup_res" in which:
        outs = lk.lookup_res_cuda(ph, tables, hop)
        refs = lk.lookup_res_plain(ph, tables, hop)
        errs = [(o - r).abs().max().item() for o, r in zip(outs, refs)]
        print(f"[{label}] lookup_res (B3a) {tuple(ph.shape)} x "
              f"{tuple(tables.shape)}: max abs err out {errs[0]:.3e} "
              f"(tolerance 2e-6, as B1), d_top {errs[1]:.3e}, d_bot "
              f"{errs[2]:.3e} (tolerance 0: differences of the same "
              f"gathered values)")
        check(errs[0] <= 2e-6 and errs[1] == 0 and errs[2] == 0,
              "lookup_res vs plain")
        rows["lookup_res"] = dict(
            err=max(errs),
            ms=cuda_ms(lambda: lk.lookup_res_cuda(ph, tables, hop), 50),
            plain_ms=cuda_ms(lambda: lk.lookup_res_plain(ph, tables, hop),
                             5),
            bound=bound(4 * (4 * n_el + tables.numel()), 17 * n_el))
    if "lookup_dtab" in which:
        g = torch.randn(ph.shape, generator=gen, device="cuda")
        frames, s = tables.shape[1], tables.shape[2]
        out = lk.lookup_dtab_cuda(ph, g, hop, frames, s)
        ref = lk.lookup_dtab_plain(ph, g, hop, frames, s)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"[{label}] lookup_dtab (B3b) {tuple(ph.shape)} -> "
              f"{tuple(out.shape)}: max abs err {err:.3e}, / max|ref| "
              f"{rel:.3e} (tolerance 1e-5: shared-memory atomics add in "
              f"an order that changes from run to run)")
        check(rel <= 1e-5 and out.shape == tables.shape,
              "lookup_dtab vs plain")
        rows["lookup_dtab"] = dict(
            err=err,
            ms=cuda_ms(lambda: lk.lookup_dtab_cuda(ph, g, hop, frames, s),
                       50),
            plain_ms=cuda_ms(lambda: lk.lookup_dtab_plain(ph, g, hop, frames,
                                                          s), 5),
            bound=bound(4 * (2 * n_el + out.numel()), 20 * n_el))

    if "allpole_const" in which:
        x_shape, a_shape = shapes["allpole_const"]
        x = torch.randn(x_shape, generator=gen, device="cuda")
        a = lpc_coeffs(gen, a_shape, "cuda")
        out = allpole_const_cuda(x, a)
        ref = allpole_const_plain(x, a)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"[{label}] allpole_const (B2) {tuple(x.shape)} p={a.shape[1]}:"
              f" max err {err:.3e}, / max|y| {rel:.3e} (tolerance 1e-5)")
        check(rel <= 1e-5 and torch.isfinite(out).all().item(),
              "allpole_const vs plain")
        rows["allpole_const"] = dict(
            err=err, ms=cuda_ms(lambda: allpole_const_cuda(x, a), 20),
            plain_ms=cuda_ms(lambda: allpole_const_plain(x, a), 3),
            bound=bound(4 * (2 * x.numel() + a.numel()), 2 * a.numel()
                        * x.shape[1]))

    if "allpole_tv" in which:
        x, a = allpole_tv_inputs(gen, shapes)
        out = allpole_cuda(x, a)
        ref = allpole_plain(x, a)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"[{label}] allpole_tv (B4) {tuple(x.shape)} p={a.shape[2]}: "
              f"max err {err:.3e}, / max|y| {rel:.3e} (tolerance 1e-4: "
              f"sequential vs two-pass blocked rounding)")
        check(rel <= 1e-4 and torch.isfinite(out).all().item(),
              "allpole_tv vs plain")
        rows["allpole_tv"] = dict(
            err=err, ms=cuda_ms(lambda: allpole_cuda(x, a), 5),
            plain_ms=cuda_ms(lambda: allpole_plain(x, a), 1, warmup=1),
            bound=bound(4 * (2 * x.numel() + a.numel()), 2 * a.numel()))
    return rows


def grads_of(fn, inputs, g):
    outs = fn(*inputs)
    return torch.autograd.grad(outs, inputs, g)


def phase_backward(shapes: dict) -> None:
    """Each autograd Function's backward through the kernels against the
    same Function on the plain versions, on the card, at the training
    shapes and on the same cotangent."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ph, tables, hop = lookup_inputs(gen, shapes)
    ph.requires_grad_()
    tables.requires_grad_()
    g = torch.randn(ph.shape, generator=gen, device="cuda")
    got = grads_of(lambda p_, t: lk.lookup_blocks(p_, t, hop, lk.CUDA_OPS),
                   (ph, tables), g)
    ref = grads_of(lambda p_, t: lk.lookup_blocks(p_, t, hop, lk.PLAIN_OPS),
                   (ph, tables), g)
    errs = [rel_err(u, v) for u, v in zip(got, ref)]
    print(f"backward lookup (B3a, then B3b) d_ph {errs[0]:.3e}, d_tables "
          f"{tuple(got[1].shape)} {errs[1]:.3e} of max|ref| (tolerance "
          f"1e-5: the atomics' order)")
    check(max(errs) <= 1e-5, "lookup backward vs plain")

    x_shape, a_shape = shapes["allpole_const"]
    x = torch.randn(x_shape, generator=gen, device="cuda").requires_grad_()
    a = lpc_coeffs(gen, a_shape, "cuda").requires_grad_()
    g = torch.randn(x_shape, generator=gen, device="cuda")
    got = grads_of(lambda x_, a_: allpole_const(x_, a_, allpole_const_cuda),
                   (x, a), g)
    ref = grads_of(lambda x_, a_: allpole_const(x_, a_, allpole_const_plain),
                   (x, a), g)
    errs = [rel_err(u, v) for u, v in zip(got, ref)]
    print(f"backward allpole_const (B2 on the reversed cotangent) dx "
          f"{errs[0]:.3e}, da {errs[1]:.3e} of max|ref| (tolerance 1e-4: "
          f"sequential vs blocked two-pass, da sums 960 products a row)")
    check(max(errs) <= 1e-4, "allpole_const backward vs plain")

    x, a = allpole_tv_inputs(gen, shapes)
    x.requires_grad_()
    a.requires_grad_()
    g = torch.randn(x.shape, generator=gen, device="cuda")
    got = grads_of(lambda x_, a_: allpole(x_, a_, allpole_cuda), (x, a), g)
    ref = grads_of(lambda x_, a_: allpole(x_, a_, allpole_plain), (x, a), g)
    errs = [rel_err(u, v) for u, v in zip(got, ref)]
    print(f"backward allpole_tv (B4 on flipped, column-shifted a) dx "
          f"{errs[0]:.3e}, da {errs[1]:.3e} of max|ref| (tolerance 1e-4: "
          f"sequential vs blocked two-pass)")
    check(max(errs) <= 1e-4, "allpole_tv backward vs plain")


def seeded_model(decoder: str, device) -> VoiceAutoEncoder:
    """Full-width model with seeded weights; the zero-initialised head and
    acoustic filter get small random values so the LPC and the room filter
    are not the identity."""
    torch.manual_seed(SEED)
    task = build_voice_autoencoder(model_config(decoder), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        head = task.encoder.backbone.out_linear
        head.weight.copy_(0.004 * torch.randn(head.weight.shape,
                                              generator=gen))
        head.bias.copy_(0.05 * torch.randn(head.bias.shape, generator=gen))
        room = task.decoder.room_filter.kernel
        room.copy_(0.01 * torch.randn(room.shape, generator=gen))
    return task.to(device)


def requests(n: int, seconds: float):
    ds = SyntheticVoiceDataset(n, seconds, SR, seed=SEED)
    items = [ds[i] for i in range(n)]
    return (torch.from_numpy(np.stack([x for x, _ in items])),
            torch.from_numpy(np.stack([f for _, f in items])))


def phase_serve(decoder: str, expect: dict) -> dict:
    dev = torch.device("cuda")
    task = seeded_model(decoder, dev)
    x, f0 = requests(BATCH, SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    task.init_running_stats(xs, f0s)
    task.eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    path = {"golf": ("lookup", "allpole_const"),
            "golf-precise": ("lookup", "allpole_tv")}[decoder]
    for k in kernels.ALL:
        k.launches = 0
    latencies = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = task.predict_step(xs, f0s, generator=gen)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
    counts = {k.name: k.launches for k in kernels.ALL}
    print(f"serve {decoder}: out {tuple(y.shape)}, launches {counts}")
    check(torch.isfinite(y.data).all().item(), f"{decoder} output finite")
    check(y.shape[0] == BATCH and y.shape[1] > 0.99 * SECONDS * SR,
          f"{decoder} output shape {y.shape}")
    for name in path:
        check(counts[name] > 0, f"{decoder} launched {name}")
        k = next(k for k in kernels.ALL if k.name == name)
        check(k.last_shapes == expect[name],
              f"{name} shapes {k.last_shapes} == {expect[name]}")
    print(f"serve {decoder}: latency per request (B={BATCH} x {SECONDS:.0f} "
          f"s, batched) first {latencies[0] * 1e3:.1f} ms, then "
          f"{', '.join(f'{s * 1e3:.1f}' for s in latencies[1:])} ms")

    # one 2 s request against the port's own CPU run, same weights + noise
    n = int(CHECK_SECONDS * SR)
    xc, f0c = x[:1, :n], f0[:1, :n]
    noise = torch.randn((1, n), generator=torch.Generator().manual_seed(7))
    cpu_task = seeded_model(decoder, "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    with torch.inference_mode():
        y_gpu, _ = task.predict_step(Sig(xc.to(dev), 1), Sig(f0c.to(dev), 1),
                                     noise=noise.to(dev))
        y_cpu, _ = cpu_task.predict_step(Sig(xc, 1), Sig(f0c, 1),
                                         noise=noise)
    rel = ((y_gpu.data.cpu() - y_cpu.data).abs().max()
           / y_cpu.data.abs().max()).item()
    print(f"serve {decoder}: 2 s request, card vs CPU: max err / max|y| "
          f"{rel:.3e} (tolerance 1e-3: cuDNN LSTM and cuFFT sum in another "
          f"order than the CPU, and the all-pole kernel runs the "
          f"sequential recurrence where the CPU runs the blocked form)")
    check(rel <= 1e-3, f"{decoder} card vs CPU")
    return counts


def train_model_config(decoder: str, dropout: float = None) -> dict:
    cfg = model_config(decoder)
    if dropout is not None:
        cfg["encoder_init_args"]["dropout"] = dropout
    return cfg


def phase_train(decoder: str, expect: dict) -> dict:
    """3 Adam steps of the full-width model on B = 64 x 2 s through the
    port's Trainer; every loss finite; the path's kernels launched at the
    training shapes."""
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    task = seeded_model(decoder, dev)
    x, f0 = requests(TRAIN_BATCH, TRAIN_SECONDS)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    trainer = Trainer(task, run_dir="chiprun_out/chip_smoke_train",
                      max_steps=TRAIN_STEPS, seed=SEED)
    task.init_running_stats(xs, f0s)
    path = {"golf": ("lookup_res", "lookup_dtab", "allpole_const"),
            "golf-precise": ("lookup_res", "lookup_dtab", "allpole_tv")
            }[decoder]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.ALL:
        k.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(xs, f0s)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        trainer.step += 1
    counts = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train {decoder}: B={TRAIN_BATCH} x {TRAIN_SECONDS:.0f} s, "
          f"losses {', '.join(f'{v:.5f}' for v in losses)}; step wall "
          f"time (host clock around synchronize, TF32 off) "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; grad norm "
          f"{metrics['grad_norm'].item():.4g}; peak memory "
          f"{peak:.2f} GiB; launches {counts}")
    check(all(np.isfinite(losses)), f"{decoder} train losses finite")
    per_step = {"lookup_res": 1, "lookup_dtab": 1, "allpole_const": 2,
                "allpole_tv": 2}
    for name in path:
        check(counts[name] >= per_step[name] * TRAIN_STEPS,
              f"{decoder} train launched {name} {counts[name]} times")
        k = next(k for k in kernels.ALL if k.name == name)
        check(k.last_shapes == expect[name],
              f"{name} shapes {k.last_shapes} == {expect[name]}")
    return counts


def phase_train_vs_cpu(decoder: str) -> None:
    """One training step at B = 2 x 1 s, full width, on the card and on the
    CPU: same weights, noise and random f0, dropout 0, train mode (cuDNN
    has no RNN backward in eval mode, and dropout draws differ by
    device)."""
    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    cpu_task = build_voice_autoencoder(train_model_config(decoder, 0.0),
                                       device="cpu")
    ref_task = seeded_model(decoder, "cpu")
    cpu_task.load_state_dict(ref_task.state_dict())
    x, f0 = requests(TRAIN_CHECK_BATCH, TRAIN_CHECK_SECONDS)
    # white noise at -20 dB of full scale: without it most spectrogram bins
    # are near silent, and the encoder's log amplifies the two FFT
    # libraries' fp32 rounding there (the conv layers' gradients then
    # differ by ~1e-2 between the card and the CPU)
    x = x + 0.1 * torch.randn(x.shape,
                              generator=torch.Generator().manual_seed(8))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    random_f0 = torch.tensor([[90.0], [310.0]])
    cpu_task.init_running_stats(Sig(x, 1), Sig(f0, 1))
    gpu_task = build_voice_autoencoder(train_model_config(decoder, 0.0),
                                       device="cpu")
    gpu_task.load_state_dict(cpu_task.state_dict())
    gpu_task.to(dev)
    grads = []
    losses = []
    for task, d in ((gpu_task, dev), (cpu_task, torch.device("cpu"))):
        task.train()
        loss, _ = task.training_step(Sig(x.to(d), 1), Sig(f0.to(d), 1),
                                     noise=noise.to(d),
                                     random_f0=random_f0.to(d))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.detach().cpu()
                      for n, p in task.named_parameters()
                      if p.requires_grad})
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    errs = {}
    for name, ref in grads[1].items():
        got = grads[0][name]
        if name.startswith("encoder.backbone.pyramid.convs.") and \
                name.endswith(".bias"):
            # in front of a train-mode batch norm: zero in exact arithmetic,
            # rounding noise on both sides; held against the scale of the
            # conv's weight gradient instead
            w = grads[1][name[:-len("bias")] + "weight"].abs().max()
            err = ((got - ref).abs().max() / w).item()
        else:
            err = ((got - ref).abs().max() / ref.abs().max()).item()
        if name.startswith("encoder.backbone.pyramid."):
            # the conv pyramid reads the log spectrogram, whose small bins
            # carry the FFT libraries' rounding (on the CPU, against
            # golf_tpu, a float64 spectrogram takes these errors from 1e-2
            # to below 1e-4): held to PYRAMID_GRAD_TOL, scaled here
            err *= TRAIN_GRAD_TOL / PYRAMID_GRAD_TOL
        errs[name] = err
    ranked = sorted(errs, key=errs.get, reverse=True)
    worst, worst_name = errs[ranked[0]], ranked[0]
    print(f"train {decoder}: card vs CPU, largest gradient errors (the "
          f"pyramid's scaled by {TRAIN_GRAD_TOL / PYRAMID_GRAD_TOL:g}): " +
          ", ".join(f"{n} {errs[n]:.2e}" for n in ranked[:4]))
    print(f"train {decoder}: B={TRAIN_CHECK_BATCH} x "
          f"{TRAIN_CHECK_SECONDS:.0f} s, card vs CPU: loss {losses[0]:.6f} "
          f"vs {losses[1]:.6f} (rel {rel_loss:.2e}, tolerance 1e-4), worst "
          f"gradient {worst_name} {worst:.2e} of its max|ref| (tolerance "
          f"{TRAIN_GRAD_TOL:g}, the conv pyramid {PYRAMID_GRAD_TOL:g}: "
          f"cuDNN, cuFFT and the sequential all-pole kernels sum in other "
          f"orders than the CPU's oneDNN, pocketfft and blocked forms)")
    check(rel_loss <= 1e-4, f"{decoder} train loss card vs CPU")
    check(worst <= TRAIN_GRAD_TOL, f"{decoder} train gradients card vs CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_environment()
    phase_build()
    serve_shapes = main_path_shapes(BATCH, int(SECONDS * SR))
    train_shapes = main_path_shapes(TRAIN_BATCH, int(TRAIN_SECONDS * SR))
    serve_rows = phase_kernels(serve_shapes)
    rows = phase_kernels(train_shapes, [k.name for k in kernels.ALL],
                         label="train")
    phase_backward(train_shapes)
    counts = {k.name: 0 for k in kernels.ALL}
    for decoder in ("golf", "golf-precise"):
        for name, c in phase_serve(decoder, serve_shapes).items():
            counts[name] += c
    for decoder in ("golf", "golf-precise"):
        for name, c in phase_train(decoder, train_shapes).items():
            counts[name] += c
        phase_train_vs_cpu(decoder)

    replaces = {"lookup": "golf_tpu/ops/lookup_pallas.py:107",
                "lookup_res": "golf_tpu/ops/lookup_pallas.py:222",
                "lookup_dtab": "golf_tpu/ops/lookup_pallas.py:128",
                "allpole_const": "golf_tpu/ops/allpole_pallas.py:89",
                "allpole_tv": "golf_tpu/ops/allpole_pallas.py:33"}
    table = []
    for k in kernels.ALL:
        r = rows[k.name]
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"golf_tpu_torch/kernels/csrc/{k.source}",
            "replaces": replaces[k.name], "launches": counts[k.name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
            "shapes": [list(s) for s in train_shapes[k.name]]}
        if k.name in serve_rows:
            sr_ = serve_rows[k.name]
            entry["serve"] = {
                "shapes": [list(s) for s in serve_shapes[k.name]],
                "max_abs_err": sr_["err"], "ms": sr_["ms"],
                "plain_ms": sr_["plain_ms"], "bound_ms": sr_["bound"][0]}
        table.append(entry)
    print("kernels: [" + "; ".join(
        f"{e['name']}: launches {e['launches']}, {e['ms'] * 1e3:.1f} us, "
        f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']}), plain "
        f"{e['plain_ms'] * 1e3:.1f} us (training shapes)" for e in table)
        + "]")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
