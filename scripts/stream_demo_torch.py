#!/usr/bin/env python
"""Streaming synthesis demo of the PyTorch/CUDA port: drive
``golf_tpu_torch.serve.GOLFStream`` (the GOLF-ss decoder) chunk by chunk on
one utterance of the config's validation data, and report per-push
latency.

The encoder runs offline on the utterance unless ``--enc_stream L``
streams it exactly-causal (``serve.StreamingEncoder``: forward LSTM state
carried, the backward directions truncated to L look-ahead frames) or
``--enc_context C`` recomputes it on a window of C frames of context and
look-ahead around each chunk. Both print the ctrl rows' error against the
offline encoder.

    python scripts/stream_demo_torch.py --config cfg/ae/synthetic.yaml \\
        --model cfg/ae/decoder/golf-precise.yaml --device cpu \\
        --enc_stream 24 --out /tmp/stream.wav

Without ``--ckpt_path`` (a checkpoint written by the port's trainer) the
weights are the seeded initialisation, with the encoder's running min/max
from the first training batch. Runs on CUDA unless ``--device cpu``.
Prints JSON lines: the encoder's and the decoder's median and p99 push
latency, the algorithmic latency, the ctrl-row error, and the real-time
factor: the utterance's length over the host time of every push and
flush, the streamed or windowed encoder's included.
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from golf_tpu_torch.config.registry import instantiate, load_config  # noqa: E402
from golf_tpu_torch.core.device import resolve_device  # noqa: E402
from golf_tpu_torch.core.sig import Sig  # noqa: E402
from golf_tpu_torch.serve import (GOLFStream, StreamingEncoder,  # noqa: E402
                                  chunk_ctrl)
from golf_tpu_torch.tasks.ae import build_voice_autoencoder  # noqa: E402
from golf_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402

STREAMED = ("harm_oscillator_params", "noise_filter_params",
            "end_filter_params")


def percentiles(seconds):
    """Median and p99 of push latencies in ms, the first four pushes left
    out when there are more (the decoder's first two return at once, its
    next two run the first window of each shape)."""
    warm = np.asarray(seconds[4:] if len(seconds) > 4 else seconds) * 1e3
    return float(np.median(warm)), float(np.percentile(warm, 99))


def timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ctrl_error(rows, ref):
    """Largest error of the streamed ctrl rows against the offline ones,
    relative to each leaf's max-abs, over the rows both have."""
    errs = []
    for k in STREAMED:
        for got, want in zip(rows[k], ref[k]):
            n = min(got.shape[1], want.shape[1])
            d = (got.data[:, :n] - want.data[:, :n]).abs().max()
            errs.append((d / (want.data.abs().max() + 1e-9)).item())
    return max(errs)


def cat_raw(parts):
    """Concatenate raw encoder outputs along time."""
    out = {}
    for k, v in parts[0].items():
        if isinstance(v, tuple):
            out[k] = tuple(Sig(torch.cat([p[k][i].data for p in parts], 1),
                               v[i].hop) for i in range(len(v)))
        else:
            out[k] = Sig(torch.cat([p[k].data for p in parts], 1), v.hop)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append", default=[])
    ap.add_argument("--model", default=None)
    ap.add_argument("--ckpt_path", default=None)
    ap.add_argument("--chunk", type=int, default=2400)
    ap.add_argument("--out", default=None)
    ap.add_argument("--enc_stream", type=int, default=0,
                    help="stream the encoder exactly-causal with this many "
                         "look-ahead frames (0: offline encoder)")
    ap.add_argument("--enc_context", type=int, default=0,
                    help="recompute the encoder on windows with this many "
                         "frames of context and look-ahead (0: off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)

    cfg = load_config(args.config, args.model, args.overrides)
    device = resolve_device(args.device)
    init_args = cfg["model"].get("init_args", cfg["model"])
    sr = init_args.get("sample_rate", 24000)
    torch.manual_seed(cfg.get("seed_everything") or 2434)
    task = build_voice_autoencoder(init_args, device=device)
    data = instantiate(cfg["data"])
    data.setup("fit")
    x_tr, f0_tr = next(iter(data.train_dataloader()))[:2]
    task.init_running_stats(Sig(torch.from_numpy(x_tr).to(device), 1),
                            Sig(torch.from_numpy(f0_tr).to(device), 1))
    if args.ckpt_path:
        ckpt_lib.restore_params_into(args.ckpt_path, task)
    task.eval()

    # one utterance, cut to whole chunks
    x, f0 = next(iter(data.val_dataloader()))[:2]
    chunk = args.chunk
    n_chunks = x.shape[1] // chunk
    t = n_chunks * chunk
    x = torch.from_numpy(x[:1, :t]).to(device)
    f0 = torch.from_numpy(f0[:1, :t]).to(device)
    dec = task.decoder

    def analyse(xs, f0s):
        """Offline encoder -> applied ctrl."""
        raw = task.encoder(Sig(xs, 1), Sig(f0s, 1))
        return dec.apply_ctrl({k: v for k, v in raw.items()
                               if k.endswith("_params")})

    with torch.inference_mode():
        ctrl = analyse(x, f0)
        phase = task.phase_from_f0(Sig(f0, 1)).data
        stream = GOLFStream(dec, chunk=chunk)
        hop = ctrl["end_filter_params"][0].hop
        chunks = [chunk_ctrl(ctrl, c, chunk) for c in range(n_chunks)]
        report = {}
        enc_host_s = 0.0     # the offline encoder is not timed

        if args.enc_stream:
            se = StreamingEncoder(task.encoder, lookahead=args.enc_stream)
            parts, enc_lat = [], []
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                r, dt = timed(lambda: se.push(x[:, sl], f0[:, sl]), device)
                enc_lat.append(dt)
                if r is not None:
                    parts.append(r)
            r, enc_flush_s = timed(se.flush, device)
            enc_host_s = sum(enc_lat) + enc_flush_s
            parts.append(r)
            raw = cat_raw([p for p in parts if p is not None])
            streamed = dec.apply_ctrl({k: v for k, v in raw.items()
                                       if k.endswith("_params")})
            chunks = [chunk_ctrl(streamed, c, chunk)
                      for c in range(n_chunks)]
            p50, p99 = percentiles(enc_lat)
            report.update({
                "enc_stream_lookahead_frames": args.enc_stream,
                "enc_algorithmic_latency_ms":
                    (args.enc_stream + se.edge) * hop / sr * 1e3,
                "enc_median_push_latency_ms": p50,
                "enc_p99_push_latency_ms": p99,
                "enc_ctrl_rel_err": ctrl_error(streamed, ctrl)})
        elif args.enc_context:
            # windows start on the table-weight pooling grid (groups of
            # hop_rate frames), else their table rows pool other frames
            rate = ctrl["harm_oscillator_params"][0].hop // hop
            ctx = -(-args.enc_context // rate) * rate * hop
            chunks, enc_lat = [], []
            for c in range(n_chunks):
                s0 = max(0, c * chunk - ctx)
                s1 = min(t, (c + 1) * chunk + ctx)
                win, dt = timed(lambda: analyse(x[:, s0:s1], f0[:, s0:s1]),
                                device)
                enc_lat.append(dt)
                rows = {}
                for k in STREAMED:
                    rows[k] = tuple(
                        Sig(s.data[:, (c * chunk - s0) // s.hop:][
                            :, :chunk // s.hop], s.hop) for s in win[k])
                chunks.append(rows)
            p50, p99 = percentiles(enc_lat)
            enc_host_s = sum(enc_lat)
            got = {k: tuple(Sig(torch.cat([r[k][i].data for r in chunks], 1),
                                ctrl[k][i].hop)
                            for i in range(len(ctrl[k]))) for k in STREAMED}
            report.update({
                "enc_context_frames": ctx // hop,
                "enc_median_push_latency_ms": p50,
                "enc_p99_push_latency_ms": p99,
                "enc_ctrl_rel_err": ctrl_error(got, ctrl)})

        outs, lat = [], []
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            out, dt = timed(lambda: stream.push(chunks[c], phase[:, sl]),
                            device)
            lat.append(dt)
            if out is not None:
                outs.append(out)
        out, flush_s = timed(lambda: stream.flush(
            chunk_ctrl(ctrl, n_chunks, chunk, rest=True)), device)
        outs.append(out)
        audio = torch.cat(outs, dim=1)[0].float().cpu().numpy()

    if args.out:
        from golf_tpu_torch.utils.wav import write_wav
        write_wav(args.out, audio, sr)
    p50, p99 = percentiles(lat)
    if report:
        print(json.dumps(report))
    print(json.dumps({
        "device": str(device), "chunks": n_chunks, "chunk_samples": chunk,
        "chunk_ms": chunk / sr * 1e3,
        "dec_algorithmic_latency_ms": 2 * chunk / sr * 1e3,
        "dec_median_push_latency_ms": p50, "dec_p99_push_latency_ms": p99,
        "real_time_factor": audio.shape[0] / sr
        / (sum(lat) + flush_s + enc_host_s),
        "samples": int(audio.shape[0]), "finite": bool(np.isfinite(
            audio).all()), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
