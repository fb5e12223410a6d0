#!/usr/bin/env python3
"""How close the streaming decoder and the offline decoder each come to a
float64 reference, on one GPU.

    python tools/stream_precision.py [--seconds 6]

``chip_smoke.py``'s seeded full-width GOLF-ss model and synthetic batch
(B = 4): the offline ctrl from the encoder on the card, then the decoder
three ways on the same ctrl and noise: offline on the card, streamed on the
card (``GOLFStream``, pushes of 2400 samples), and offline in float64 on
the CPU: the whole decoder in float64, its oscillator's phase integrated by
a float64 cumsum (the oscillator rounds the increments to float32, and
``wrapped_cumsum`` would round its block totals to float32 again; only the
first rounding stays here). Prints each pair's largest error relative to
the reference's max|y|, over the whole clip and second by second, the
same for the harmonic source alone, and the harmonic source's stages.
Both decoders are also held against the float64 decoder whose phase goes
through ``wrapped_cumsum`` on the CPU (float32 block offsets and mod-1
scan), which shares the offline decoder's phase rounding.

Then the served audio's card-vs-CPU error (``chip_smoke.py``'s serve
check: one 2 s request, same weights and noise) for each decoder, with the
phase increment f0 / sample_rate (and ``linear_upsample``'s weights) formed
on the card as a product with the divisor's rounded reciprocal (PyTorch's
``tensor / python_number`` on CUDA; the port's form before
``core.sig.true_divide``) and as a true division (as shipped), split into
the encoder's ctrl rows, the wrapped phase, the harmonic source and the
decoder alone on the CPU's ctrl, and the wrapped phase's difference split
into the summation's and the increments'. Last, ``wrapped_cumsum``'s
cotangent (the reversed cumsum) at the training shape: its error against
a float64 reversed cumsum on the card accumulated in float32 (the port's
form before) and in float64 (as shipped), beside the CPU's, and the two
forms' times on the card.

TF32 is off. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.core import sig  # noqa: E402
from golf_tpu_torch.core.sig import Sig  # noqa: E402
from golf_tpu_torch.models import synth  # noqa: E402
from golf_tpu_torch.tasks import ae  # noqa: E402
from golf_tpu_torch.ops import dsp  # noqa: E402
from golf_tpu_torch.serve import GOLFStream, chunk_ctrl  # noqa: E402


def product_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` with ``d`` a Python number: on CUDA a product with the
    rounded reciprocal of ``d``."""
    return x / d


def reversed_cumsum_f32(g: torch.Tensor) -> torch.Tensor:
    """The cotangent in the input's dtype: on CUDA a float32
    accumulation."""
    return torch.flip(torch.cumsum(torch.flip(g, (1,)), dim=1), (1,))


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double().cpu() - ref.double().cpu()).abs().max()
            / ref.double().abs().max()).item()


def served_vs_cpu(decoder: str, dev: torch.device) -> None:
    """``chip_smoke.phase_serve``'s card-vs-CPU check, split by stage, for
    the card's phase increments as a product and as a true division."""
    task = chip_smoke.seeded_model(decoder, dev)
    x, f0 = chip_smoke.requests(chip_smoke.BATCH, chip_smoke.SECONDS)
    task.init_running_stats(Sig(x.to(dev), 1), Sig(f0.to(dev), 1))
    task.eval()
    n = int(chip_smoke.CHECK_SECONDS * chip_smoke.SR)
    xc, f0c = x[:1, :n], f0[:1, :n]
    noise = torch.randn((1, n), generator=torch.Generator().manual_seed(7))
    cpu_task = chip_smoke.seeded_model(decoder, "cpu")
    cpu_task.load_state_dict({k: v.cpu() for k, v in
                              task.state_dict().items()})
    cpu_task.eval()
    osc = cpu_task.decoder.harm_oscillator
    k = osc.oversampling

    def parts(t, xs, f0s, nz, ctrl=None):
        """Served audio, ctrl, wrapped phase, harmonic source, and the
        decoder's output on ``ctrl`` (its own ctrl by default)."""
        y, _ = t.predict_step(xs, f0s, noise=nz)
        raw = t.encoder(xs, f0s)
        own = t.decoder.apply_ctrl({k_: v for k_, v in raw.items()
                                    if k_.endswith("_params")})
        ctrl = own if ctrl is None else ctrl
        phase = t.phase_from_f0(f0s).data
        up = Sig(phase / k, k).reduce_hop_length().data
        harm = t.decoder.harm_oscillator(
            Sig(phase, 1), *ctrl["harm_oscillator_params"]).data
        dec = t.decoder(Sig(phase, 1), **ctrl, noise=nz).data
        return (y.data, own, up.float(), synth.wrapped_cumsum(up.float()),
                harm, dec)

    def cycles(a: torch.Tensor, b: torch.Tensor) -> float:
        d = (a.double().cpu() - b.double().cpu()).abs()
        return torch.minimum(d, 1 - d).max().item()

    with torch.inference_mode():
        y_c, ctrl_c, up_c, w_c, harm_c, dec_c = parts(
            cpu_task, Sig(xc, 1), Sig(f0c, 1), noise)
        ctrl_on_card = {k_: tuple(Sig(s.data.to(dev), s.hop) for s in v)
                        for k_, v in ctrl_c.items() if isinstance(v, tuple)}
        shipped = sig.true_divide
        try:
            for label, fn in (("reciprocal product", product_divide),
                              ("true division", shipped)):
                sig.true_divide = ae.true_divide = fn
                y_g, ctrl_g, up_g, w_g, harm_g, dec_g = parts(
                    task, Sig(xc.to(dev), 1), Sig(f0c.to(dev), 1),
                    noise.to(dev), ctrl_on_card)
                ctrl_err = max(rel(a.data, b.data)
                               for key in ctrl_c if isinstance(ctrl_c[key],
                                                               tuple)
                               for a, b in zip(ctrl_g[key], ctrl_c[key]))
                print(f"served {decoder}, {chip_smoke.CHECK_SECONDS:g} s, card "
                      f"({label}) vs "
                      f"CPU: audio {rel(y_g, y_c):.3e} of max|y|; its "
                      f"ctrl rows {ctrl_err:.3e} of each leaf's max-abs; "
                      f"wrapped phase {cycles(w_g, w_c):.3e} cycles; on the "
                      f"CPU's ctrl: harmonic source "
                      f"{rel(harm_g, harm_c):.3e}, decoder "
                      f"{rel(dec_g, dec_c):.3e} of max|y|")
                # the phase's difference, split: the card's wrapped phase
                # against the CPU's wrapped_cumsum of the card's own
                # increments (the summation alone), and the increments'
                # own difference, as a relative bias and as the float64
                # running sum of their difference (the drift, in cycles)
                own = cycles(w_g, synth.wrapped_cumsum(up_g.cpu()))
                d_inc = up_g.double().cpu() - up_c.double()
                print(f"  wrapped phase, card ({label}) vs the "
                      f"CPU's on the card's increments: {own:.3e} cycles; "
                      f"increments card vs CPU: mean relative difference "
                      f"{(d_inc / up_c.double()).mean().item():.3e}, "
                      f"{(d_inc != 0).double().mean().item():.3f} of them "
                      f"differ, running sum of the difference "
                      f"{torch.cumsum(d_inc, 1).abs().max().item():.3e} "
                      f"cycles")
        finally:
            sig.true_divide = ae.true_divide = shipped


def cumsum_backward(dev: torch.device) -> None:
    """``wrapped_cumsum``'s cotangent at the training step's oversampled
    length (B = 64 x 2 s at 96 kHz) on a seeded normal g: each form's
    largest error against a float64 reversed cumsum, absolute and of the
    reference's max-abs, on the card and on the CPU; the card's times
    (CUDA events with the stream held busy, ``chip_smoke.cuda_ms``)."""
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 192000)).astype(np.float32))
    ref = torch.flip(torch.cumsum(torch.flip(g, (1,)).double(), 1), (1,))
    scale = ref.abs().max().item()
    gd = g.to(dev)
    for label, fn, x in (("card float32", reversed_cumsum_f32, gd),
                         ("card float64", dsp.reversed_cumsum, gd),
                         ("CPU float32 cumsum", reversed_cumsum_f32, g),
                         ("CPU float64", dsp.reversed_cumsum, g)):
        err = (fn(x).double().cpu() - ref).abs().max().item()
        print(f"wrapped_cumsum cotangent at (64, 192000), {label}: max err "
              f"{err:.3e}, {err / scale:.3e} of max|ref| ({scale:.1f})")
    t32 = chip_smoke.cuda_ms(lambda: reversed_cumsum_f32(gd), 20)
    t64 = chip_smoke.cuda_ms(lambda: dsp.reversed_cumsum(gd), 20)
    print(f"wrapped_cumsum cotangent at (64, 192000) on the card: float32 "
          f"{t32:.4f} ms, float64 {t64:.4f} ms (CUDA events)")


def report(name: str, got: torch.Tensor, ref: torch.Tensor, sr: int) -> None:
    t = min(got.shape[1], ref.shape[1])
    err = (got[:, :t].double().cpu() - ref[:, :t].double().cpu()).abs()
    scale = ref.abs().max().item()
    per_s = [err[:, i:i + sr].max().item() / scale for i in range(0, t, sr)]
    print(f"{name}: {err.max().item() / scale:.3e} of max|ref|; by second "
          + ", ".join(f"{v:.2e}" for v in per_s))


def stages(osc, phase: torch.Tensor, weights: Sig, room, y: torch.Tensor
           ) -> None:
    """The harmonic source's stages (``IndexedGlottalFlowTable.forward``),
    each on the card in float32 against float64 on the CPU from the same
    inputs: the wrapped phase (cycles), the table lookup with the
    equal-energy gain, the decimation alone (the float32 run given the
    float64 lookup output rounded to float32), and the room filter alone
    (on the offline output)."""
    from golf_tpu_torch.ops.dsp import wrapped_cumsum
    from golf_tpu_torch.ops.resample import decimate

    k = osc.oversampling
    interp = osc._interp_tables(weights)
    interp = Sig(interp.data, interp.hop * k)
    up = Sig(phase / k, k).reduce_hop_length().data
    up64 = up.double().cpu()
    wrapped = wrapped_cumsum(up)
    wrapped64 = torch.remainder(torch.cumsum(up64, dim=1), 1)
    d = (wrapped.double().cpu() - wrapped64).abs()
    d = torch.minimum(d, 1 - d)
    print(f"  wrapped phase, card float32 vs float64: {d.max().item():.3e} "
          f"cycles at most, by second " + ", ".join(
              f"{d[:, i:i + 96000].max().item():.1e}"
              for i in range(0, d.shape[1], 96000)))
    tab = osc.generate(Sig(wrapped, 1), interp).data * torch.rsqrt(up)
    tab64 = osc.generate(Sig(wrapped64, 1), Sig(interp.data.double().cpu(),
                                                 interp.hop)).data \
        * torch.rsqrt(up64)
    report("  lookup and gain, card vs float64", tab, tab64, 4 * 24000)
    dec32 = decimate(tab64.float().to(tab.device), k)
    report("  decimation alone, card vs float64", dec32, decimate(tab64, k),
           24000)
    room64 = copy.deepcopy(room).cpu().double()
    report("  room filter alone, card vs float64",
           room(Sig(y, 1)).data, room64(Sig(y.double().cpu(), 1)).data,
           24000)


def to64(sigs):
    return tuple(Sig(s.data.double().cpu(), s.hop) for s in sigs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=chip_smoke.SECONDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_precision: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.phase_environment()
    kernels.build(kernels.ALL)
    dev = torch.device("cuda")
    sr, chunk = chip_smoke.SR, chip_smoke.STREAM_CHUNK
    task = chip_smoke.seeded_model("golf-precise", dev)
    x, f0 = chip_smoke.requests(chip_smoke.BATCH, args.seconds)
    xs, f0s = Sig(x.to(dev), 1), Sig(f0.to(dev), 1)
    task.init_running_stats(xs, f0s)
    task.eval()
    dec = task.decoder
    t = x.shape[1]
    noise = torch.randn((chip_smoke.BATCH, t), device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
    with torch.inference_mode():
        raw = task.encoder(xs, f0s)
        ctrl = dec.apply_ctrl({k: v for k, v in raw.items()
                               if k.endswith("_params")})
        phase = task.phase_from_f0(f0s).data
        y_off = dec(Sig(phase, 1), **ctrl, noise=noise).data
        harm = dec.harm_oscillator(Sig(phase, 1),
                                   *ctrl["harm_oscillator_params"]).data
        stream = GOLFStream(dec, chunk=chunk)
        n = t // chunk
        parts = []
        for c in range(n):
            sl = slice(c * chunk, (c + 1) * chunk)
            out = stream.push(chunk_ctrl(ctrl, c, chunk), phase[:, sl],
                              noise[:, sl])
            if out is not None:
                parts.append(out)
        parts.append(stream.flush(chunk_ctrl(ctrl, n, chunk, rest=True)))
        y_str = torch.cat(parts, dim=1)

        dec64 = copy.deepcopy(dec).cpu().double()
        ctrl64 = {k: to64(v) for k, v in ctrl.items()
                  if isinstance(v, tuple)}
        phase64 = Sig(phase.double().cpu(), 1)
        y64_port = dec64(phase64, **ctrl64, noise=noise.double().cpu()).data
        plain_cumsum = synth.wrapped_cumsum
        synth.wrapped_cumsum = lambda inc: torch.remainder(
            torch.cumsum(inc.double(), dim=1), 1)
        try:
            y64 = dec64(phase64, **ctrl64, noise=noise.double().cpu()).data
            harm64 = dec64.harm_oscillator(
                phase64, *ctrl64["harm_oscillator_params"]).data
        finally:
            synth.wrapped_cumsum = plain_cumsum
    print(f"B={chip_smoke.BATCH} x {args.seconds:g} s, pushes of {chunk}")
    report("stream (card) vs offline (card)", y_str, y_off, sr)
    report("offline (card) vs float64 (CPU)", y_off, y64, sr)
    report("stream (card) vs float64 (CPU)", y_str, y64, sr)
    report("harmonic source, offline (card) vs float64 (CPU)", harm, harm64,
           sr)
    report("offline (card) vs float64 with the port's wrapped phase (CPU)",
           y_off, y64_port, sr)
    report("stream (card) vs float64 with the port's wrapped phase (CPU)",
           y_str, y64_port, sr)
    with torch.inference_mode():
        stages(dec.harm_oscillator, phase,
               ctrl["harm_oscillator_params"][0], dec.room_filter, y_off)
    for decoder in ("golf", "golf-precise"):
        served_vs_cpu(decoder, dev)
    cumsum_backward(dev)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
