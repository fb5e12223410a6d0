#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (golf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. environment: versions, the card's name and power limit; TF32 off;
2. build: every CUDA kernel of the serving path, from
   ``golf_tpu_torch/kernels/csrc``;
3. kernels vs their plain PyTorch versions, on the card, at the shapes the
   serving path gives them, with each one's time, its plain version's time
   and its roofline bound;
4. serve: the full-width Interspeech24 autoencoder (the encoder of
   ``cfg/ae/vctk.yaml``) with the GOLF-ff decoder (``golf.yaml``), then the
   GOLF-ss decoder (``golf-precise.yaml``), seeded random weights, answers
   4 synthetic 6 s requests batched as B = 4; each kernel's launch count
   must move; one 2 s request is held against the port's own CPU run;
5. summary: a ``kernels:`` line, then one JSON line per kernel table;
6. last line: ``{"ok": true, "device": {...}}``.

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
from golf_tpu_torch.ops.allpole import (allpole_const_cuda,
                                        allpole_const_plain, allpole_cuda,
                                        allpole_plain)
from golf_tpu_torch.ops.dsp import rc2lpc
from golf_tpu_torch.ops.lookup import lookup_blocks_cuda, lookup_blocks_plain
from golf_tpu_torch.tasks.ae import VoiceAutoEncoder, build_voice_autoencoder
from golf_tpu_torch.tasks.data import SyntheticVoiceDataset

SEED = 0
SR = 24000
BATCH = 4
SECONDS = 6.0
CHECK_SECONDS = 2.0
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
    """Operand shapes each kernel gets from the serving path for ``batch``
    clips of ``t`` samples at the vctk widths (hop 240, 4x oversampling,
    table hop 10 frames, 960-sample GOLF-ff windows, order 22)."""
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
    return {
        "lookup": ((batch, blocks, hop_os), (batch, table_rows, 2048)),
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


def phase_kernels(shapes: dict) -> dict:
    """Each kernel against its plain version on the same inputs."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    (b, blocks, hop), tab_shape = shapes["lookup"]
    ph = torch.rand((b, blocks, hop), generator=gen, device=dev)
    tables = torch.randn(tab_shape, generator=gen, device=dev)
    out = lookup_blocks_cuda(ph, tables, hop)
    ref = lookup_blocks_plain(ph, tables, hop)
    err = (out - ref).abs().max().item()
    print(f"lookup {tuple(ph.shape)} x {tuple(tables.shape)}: "
          f"max abs err {err:.3e} (tolerance 2e-6)")
    check(err <= 2e-6, "lookup vs plain")
    n_el = ph.numel()
    rows["lookup"] = dict(
        err=err, ms=cuda_ms(lambda: lookup_blocks_cuda(ph, tables, hop), 200),
        plain_ms=cuda_ms(lambda: lookup_blocks_plain(ph, tables, hop), 20),
        bound=bound(4 * (2 * n_el + tables.numel()), 15 * n_el))

    x_shape, a_shape = shapes["allpole_const"]
    x = torch.randn(x_shape, generator=gen, device=dev)
    a = lpc_coeffs(gen, a_shape, dev)
    out = allpole_const_cuda(x, a)
    ref = allpole_const_plain(x, a)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"allpole_const {tuple(x.shape)} p={a.shape[1]}: max err "
          f"{err:.3e}, / max|y| {rel:.3e} (tolerance 1e-5)")
    check(rel <= 1e-5 and torch.isfinite(out).all().item(),
          "allpole_const vs plain")
    rows["allpole_const"] = dict(
        err=err, ms=cuda_ms(lambda: allpole_const_cuda(x, a), 50),
        plain_ms=cuda_ms(lambda: allpole_const_plain(x, a), 5),
        bound=bound(4 * (2 * x.numel() + a.numel()), 2 * a.numel()
                    * x.shape[1]))

    x_shape, a_shape = shapes["allpole_tv"]
    bsz, t = x_shape
    frames = -(-t // 240) + 1
    x = torch.randn(x_shape, generator=gen, device=dev)
    a_frames = lpc_coeffs(gen, (bsz, frames, a_shape[2]), dev)
    a = linear_upsample(a_frames, 240, axis=1)[:, :t].contiguous()
    out = allpole_cuda(x, a)
    ref = allpole_plain(x, a)
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"allpole_tv {tuple(x.shape)} p={a.shape[2]}: max err {err:.3e}, "
          f"/ max|y| {rel:.3e} (tolerance 1e-4: sequential vs two-pass "
          f"blocked rounding)")
    check(rel <= 1e-4 and torch.isfinite(out).all().item(),
          "allpole_tv vs plain")
    rows["allpole_tv"] = dict(
        err=err, ms=cuda_ms(lambda: allpole_cuda(x, a), 10),
        plain_ms=cuda_ms(lambda: allpole_plain(x, a), 3, warmup=1),
        bound=bound(4 * (2 * x.numel() + a.numel()), 2 * a.numel()))
    return rows


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_environment()
    phase_build()
    t = int(SECONDS * SR)
    shapes = main_path_shapes(BATCH, t)
    rows = phase_kernels(shapes)
    counts = {k.name: 0 for k in kernels.ALL}
    for decoder in ("golf", "golf-precise"):
        for name, c in phase_serve(decoder, shapes).items():
            counts[name] += c

    replaces = {"lookup": "golf_tpu/ops/lookup_pallas.py:107",
                "allpole_const": "golf_tpu/ops/allpole_pallas.py:89",
                "allpole_tv": "golf_tpu/ops/allpole_pallas.py:33"}
    table = []
    for k in kernels.ALL:
        r = rows[k.name]
        table.append({
            "name": k.name, "route": "cuda",
            "source": f"golf_tpu_torch/kernels/csrc/{k.source}",
            "replaces": replaces[k.name], "launches": counts[k.name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None})
    print("kernels: [" + "; ".join(
        f"{e['name']}: launches {e['launches']}, {e['ms'] * 1e3:.1f} us, "
        f"bound {e['bound_ms'] * 1e3:.1f} us ({e['bound_by']}), plain "
        f"{e['plain_ms'] * 1e3:.1f} us" for e in table) + "]")
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
