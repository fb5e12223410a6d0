#!/usr/bin/env python3
"""B4 (``allpole_tv.cu``) by chunk length, on one GPU.

    python tools/allpole_chunk_sweep.py [--chunks 64 128 256 512]
                                        [--shapes push4 shard16 ...]

For each shape and chunk length (``chunk_for`` forced to it), p = 22, with
the coefficients of ``chip_smoke.py``, in one run on one card:

* the training shape (64, 47 760), the serving shape (4, 143 761) and
  test_rtf's (1, 144 000): the forward and the adjoint entry;
* a push (4 | 1, 2400): the forward entry from an initial state zi;
* a time shard's window (64 | 32 | 16, 24 000): the forward entry from
  zi, the summary entry, the re-run entry from the summary's maps, and
  summary + re-run (a shard's work a direction);

each entry's time (CUDA events, as ``chip_smoke.py`` times them), its
kernels' device times (``torch.profiler``), its largest error against its
plain mirror at the same chunk length (``allpole_chunked_plain``; the
summary against ``allpole_summary_chunked_plain``), relative to max|ref|,
and whether the re-run equals the zi entry bit for bit. Each shape also
gets the entries before the redesign (``tools/allpole_tv_pr15.cu``, chunks
of 512) on the same inputs, and the chunk length ``chunk_for`` picks.
``--variants '' 'kMinCtas=16' 'kCarryStages=32' nc=1 'kRerunPair=4 nc=4'``
first times variants of the source at ``chunk_for``'s lengths, in turns:
``kName=V`` sets a ``constexpr int`` of ``allpole_tv.cu`` (phases 1 and 3's
CTAs an SM, the carry's maps in flight, the chunks a paired re-run CTA
takes) in a copy under the kernels' build directory, ``nc=V`` has the
wrappers ask for V chunks a re-run CTA where ``rerun_chunks`` asks for 2
(V > 2 needs ``kRerunPair=V`` beside it); '' is the source as it is. Prints
one JSON line per shape. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.ops import allpole as tap  # noqa: E402

# (label, B, T, kind): "full" the forward and adjoint entries, "zi" the
# forward from zi, "shard" zi, summary and re-run
SHAPES = (("train", 64, 47760, "full"), ("serve", 4, 143761, "full"),
          ("rtf", 1, 144000, "full"), ("push4", 4, 2400, "zi"),
          ("push1", 1, 2400, "zi"), ("shard64", 64, 24000, "shard"),
          ("shard32", 32, 24000, "shard"), ("shard16", 16, 24000, "shard"))


def kernel_name(key: str) -> str:
    """``chunk_kernel<22, false, true>`` from a profiler key (the template
    arguments name the phase: ``<P, ADJ, MAPS>``, MAPS phase 1)."""
    m = re.search(r"(\w+_kernel)(<[^>]*>)?", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


def device_us(fn, reps: int = 3) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        if "_kernel" in ev.key and ev.device_time_total:
            name = kernel_name(ev.key)
            out[name] = round(out.get(name, 0.0)
                              + ev.device_time_total / reps, 2)
    return out


def rel(out, ref) -> float:
    """Largest error over max|ref|; a floor of 1e-30 keeps 0 / 0 out (a
    map over 24 000 steps decays below float64's range)."""
    return ((out.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-30)).item()


def variant_kernels(spec: str) -> dict:
    """B4's forward, adjoint and summary entries built from a copy of
    ``allpole_tv.cu`` with the constants of ``spec`` (its ``kName=V``
    items) set, by entry name; the source as it is without such items."""
    src = Path(tap.__file__).resolve().parents[1] / "kernels" / "csrc" \
        / "allpole_tv.cu"
    text = src.read_text()
    consts = [i for i in spec.split() if i.startswith("k")]
    for item in consts:
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{int(value)};", text)
        if n != 1:
            raise SystemExit(f"allpole_chunk_sweep: no constexpr int {name} "
                             f"in {src.name}")
    tag = "_".join(consts).replace("=", "") or "default"
    if consts:
        src = kernels.BUILD / "variants" / f"allpole_tv_{tag}.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
    return {name: kernels.CudaKernel(f"{name}_{tag}", str(src), base.symbol,
                                     base.argtypes)
            for name, base in (("ALLPOLE_TV", kernels.ALLPOLE_TV),
                               ("ALLPOLE_TV_ADJ", kernels.ALLPOLE_TV_ADJ),
                               ("ALLPOLE_TV_SUMMARY",
                                kernels.ALLPOLE_TV_SUMMARY))}


def variant_pairs(spec: str):
    """``rerun_chunks`` under ``spec``: its ``nc=V`` item where the source's
    asks for 2, else the source's."""
    pairs = [int(i.split("=")[1]) for i in spec.split()
             if i.startswith("nc=")]
    if not pairs:
        return tap.rerun_chunks
    base = tap.rerun_chunks
    return lambda b, t, p: pairs[0] if base(b, t, p) == 2 else 1


def sweep_variants(specs, gen) -> dict:
    """At chunk_for's lengths: B4 and its adjoint at training, the zi entry
    at a push and at (64, 24 000), and the summary there, with each variant
    of ``specs``, in turns (each twice, the second pass in reverse order),
    and each variant's forward against the source's own, bit for bit."""
    variants = {spec: (variant_kernels(spec), variant_pairs(spec))
                for spec in specs}
    kernels.build([k for v, _ in variants.values() for k in v.values()])
    x, a = cs.allpole_tv_inputs(gen, {"allpole_tv": ((64, 47760),
                                                     (64, 47760, 22))})
    xs, as_ = cs.allpole_tv_inputs(gen, {"allpole_tv": ((64, 24000),
                                                        (64, 24000, 22))})
    xp, ap = cs.allpole_tv_inputs(gen, {"allpole_tv": ((4, 2400),
                                                       (4, 2400, 22))})
    zs = torch.randn((64, 22), generator=gen, device="cuda")
    zp = torch.randn((4, 22), generator=gen, device="cuda")
    cases = {"train_forward": lambda: tap.allpole_cuda(x, a),
             "train_adjoint": lambda: tap.allpole_adjoint_cuda(x, a),
             "shard64_zi": lambda: tap.allpole_cuda(xs, as_, zs),
             "shard64_summary": lambda: tap.allpole_summary_cuda(xs, as_),
             "push4_zi": lambda: tap.allpole_cuda(xp, ap, zp)}
    ref = {"train": tap.allpole_cuda(x, a), "push": tap.allpole_cuda(xp, ap,
                                                                     zp)}
    saved = {name: getattr(tap, name)
             for name in list(variants[specs[0]][0]) + ["rerun_chunks"]}
    res = {spec: {} for spec in specs}
    try:
        for turn in list(specs) + list(specs)[::-1]:
            ks, pairs = variants[turn]
            for name, k in ks.items():
                setattr(tap, name, k)
            tap.rerun_chunks = pairs
            res[turn]["same"] = (
                torch.equal(tap.allpole_cuda(x, a), ref["train"])
                and torch.equal(tap.allpole_cuda(xp, ap, zp), ref["push"]))
            for case, fn in cases.items():
                reps = 200 if case.startswith("push") else 20
                res[turn].setdefault(case, []).append(cs.cuda_ms(fn, reps))
            res[turn].setdefault("kernels_us", []).append(device_us(
                cases["push4_zi"]))
    finally:
        for name, k in saved.items():
            setattr(tap, name, k)
    print(json.dumps({"variants_ms": res}), flush=True)
    return res


def sweep_shape(label, b, t, kind, chunks, gen) -> dict:
    x, a = cs.allpole_tv_inputs(gen, {"allpole_tv": ((b, t), (b, t, 22))})
    zi = torch.randn((b, 22), generator=gen, device="cuda")
    g = torch.randn((b, t), generator=gen, device="cuda")
    reps = 200 if t <= 2400 else 20
    out = {"shape": [b, t], "chunk_for": tap.chunk_for(b, t), "chunks": {}}
    # before the redesign: chunks of 512
    if kind == "full":
        out["earlier_ms"] = {
            "forward": cs.cuda_ms(lambda: cs.earlier_tv(cs.EARLIER_TV, x, a),
                                  reps),
            "adjoint": cs.cuda_ms(lambda: cs.earlier_tv(cs.EARLIER_TV_ADJ, g,
                                                        a), reps)}
    else:
        out["earlier_ms"] = {"zi": cs.cuda_ms(
            lambda: cs.earlier_tv(cs.EARLIER_TV, x, a, zi), reps)}
    out["earlier_kernels_us"] = device_us(
        (lambda: cs.earlier_tv(cs.EARLIER_TV, x, a)) if kind == "full"
        else (lambda: cs.earlier_tv(cs.EARLIER_TV, x, a, zi)))
    if kind == "shard":
        out["earlier_summary_kernels_us"] = device_us(
            lambda: cs.earlier_summary(x, a))
        out["earlier_ms"]["summary"] = cs.cuda_ms(
            lambda: cs.earlier_summary(x, a), reps)
        out["earlier_ms"]["summary_plus_zi"] = cs.cuda_ms(
            lambda: (cs.earlier_summary(x, a),
                     cs.earlier_tv(cs.EARLIER_TV, x, a, zi)), reps)
    chunk_for = tap.chunk_for
    try:
        for chunk in chunks:
            tap.chunk_for = lambda *_: chunk
            row = {}
            if kind == "full":
                y, dx = tap.allpole_cuda(x, a), tap.allpole_adjoint_cuda(g, a)
                row["err"] = max(
                    rel(y, tap.allpole_chunked_plain(x, a, chunk)),
                    rel(dx, tap.allpole_chunked_plain(g, a, chunk,
                                                      adjoint=True)))
                if chunk == cs.EARLIER_CHUNK:
                    row["equals_earlier"] = (
                        torch.equal(y, cs.earlier_tv(cs.EARLIER_TV, x, a))
                        and torch.equal(dx, cs.earlier_tv(cs.EARLIER_TV_ADJ,
                                                          g, a)))
                row["forward_ms"] = cs.cuda_ms(lambda: tap.allpole_cuda(x, a),
                                               reps)
                row["adjoint_ms"] = cs.cuda_ms(
                    lambda: tap.allpole_adjoint_cuda(g, a), reps)
                row["kernels_us"] = device_us(
                    lambda: (tap.allpole_cuda(x, a),
                             tap.allpole_adjoint_cuda(g, a)))
            else:
                y = tap.allpole_cuda(x, a, zi)
                row["err"] = rel(y, tap.allpole_chunked_plain(x, a, chunk,
                                                              zi=zi))
                row["zi_ms"] = cs.cuda_ms(lambda: tap.allpole_cuda(x, a, zi),
                                          reps)
                row["kernels_us"] = device_us(lambda: tap.allpole_cuda(x, a,
                                                                       zi))
            if kind == "shard":
                m, v, maps = tap.allpole_summary_cuda(x, a)
                m_p, v_p, maps_p = tap.allpole_summary_chunked_plain(x, a,
                                                                     chunk)
                row["summary_err"] = max(rel(m, m_p), rel(v, v_p))
                row["maps_err"] = rel(maps, maps_p)
                row["rerun_equals_zi"] = torch.equal(
                    tap.allpole_rerun_cuda(x, a, zi, maps), y)
                row["summary_ms"] = cs.cuda_ms(
                    lambda: tap.allpole_summary_cuda(x, a), reps)
                row["rerun_ms"] = cs.cuda_ms(
                    lambda: tap.allpole_rerun_cuda(x, a, zi, maps), reps)

                def shard_dir():
                    m_, v_, maps_ = tap.allpole_summary_cuda(x, a)
                    return tap.allpole_rerun_cuda(x, a, zi, maps_)
                row["summary_plus_rerun_ms"] = cs.cuda_ms(shard_dir, reps)
                row["summary_kernels_us"] = device_us(
                    lambda: tap.allpole_summary_cuda(x, a))
            out["chunks"][chunk] = row
            print(f"{label} ({b}, {t}) chunk {chunk}: {json.dumps(row)}",
                  flush=True)
    finally:
        tap.chunk_for = chunk_for
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=[64, 128, 256, 512])
    ap.add_argument("--shapes", nargs="+", default=[s[0] for s in SHAPES])
    ap.add_argument("--variants", nargs="*", default=[],
                    help="also time these variants, each a space-separated "
                         "string of kName=V (a constexpr int of "
                         "allpole_tv.cu) and nc=V items ('' the source as "
                         "it is; put it first), e.g. 'kMinCtas=16'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("allpole_chunk_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = cs.phase_environment()
    kernels.build(kernels.ALL + cs.EARLIER)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if args.variants:
        sweep_variants(args.variants, gen)
    for label, b, t, kind in SHAPES:
        if label in args.shapes:
            res = sweep_shape(label, b, t, kind, args.chunks, gen)
            print(json.dumps({label: res}), flush=True)
            torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
