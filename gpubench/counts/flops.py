"""The model FLOPs of one training step or one batched resynthesis of a
GOLF configuration, from its sizes and the batch's shape.

Counted (two FLOPs a multiply-add):
* convolutions in direct form, whatever algorithm runs them: the conv
  pyramid, the Kaiser-sinc decimation, the noise filter's frame-wise FIR,
  the room filter's FIR;
* the BiLSTM's gate products, the linear layers (the head, the wavetable
  index's GLU);
* FFTs at 5 N log2 N each: the encoder's spectrogram, the noise filter's
  kernel design, the loss's spectrograms;
* the all-pole recursions at 2 p a sample (the frame-wise filter's every
  window sample).
Training adds the backward without recomputation: each product again for
each operand that takes a gradient (the pyramid's first conv and the fixed
decimation filter need no second one, the noise filter's FIR needs no
gradient of the noise), one FFT a transform on the gradient's path (none
for the input's spectrograms), and the all-pole adjoint and its
coefficient gradient. Elementwise work, the table lookup and the optimizer
are not counted.
"""

from __future__ import annotations

import math
from typing import Dict


def fft(n: int) -> float:
    return 5.0 * n * math.log2(n)


def _sizes(config: Dict) -> Dict:
    m = config["model"]
    enc = m["encoder_init_args"]
    dec = m["decoder"]["init_args"]
    harm = dec["harm_oscillator"]["init_args"]
    end = dec["end_filter"]
    return {
        "n_fft": enc["n_fft"], "hop": enc["hop_length"],
        "channels": enc["channels"], "strides": enc["strides"],
        "hidden": enc["lstm_hidden_size"], "layers": enc["num_layers"],
        "harm_ch": harm["in_channels"], "hop_rate": harm["hop_rate"],
        "k": harm["oversampling"],
        "n_mag": dec["noise_filter"]["init_args"]["n_mag"],
        "p": end["init_args"]["lpc_order"],
        "ws": (end["init_args"].get("window_length", 960)
               if end["class_path"].endswith("LTVMinimumPhaseFilter")
               else None),
        "room": dec["room_filter"]["init_args"]["length"],
        "n_ffts": m["criterion"]["init_args"]["n_ffts"],
    }


def parts(config: Dict, batch: int, t: int) -> Dict[str, Dict[str, float]]:
    """Each counted operation's forward FLOPs for the batch and how many
    times again the backward counts it."""
    s = _sizes(config)
    b, hop = batch, s["hop"]
    frames = t // hop + 1                      # centred spectrogram
    tf = min(frames, -(-t // hop))             # f0 frames: the head's rows
    out = {}
    out["stft"] = {"fwd": b * frames * fft(s["n_fft"]), "bwd": 0}
    fr, cin = s["n_fft"] // 2 + 1, 1
    for i, (o, st) in enumerate(zip(s["channels"], s["strides"])):
        out[f"conv{i}"] = {"fwd": 2.0 * b * o * fr * tf * cin * (2 * st + 1)
                           * 3, "bwd": 1 if i == 0 else 2}
        fr //= st
        cin = o
    h = s["hidden"]
    n_in = fr * cin + 1
    lstm = 0.0
    for _ in range(s["layers"]):
        lstm += 2 * 2.0 * 4 * h * (n_in + h) * b * tf
        n_in = 2 * h
    out["lstm"] = {"fwd": lstm, "bwd": 2}
    head = s["harm_ch"] + s["n_mag"] + 1 + s["p"]
    out["head"] = {"fwd": 2.0 * b * tf * 2 * h * head, "bwd": 2}
    c = s["harm_ch"]
    nd = (tf + 2 * (s["hop_rate"] // 2) - s["hop_rate"]) // s["hop_rate"] + 1
    out["glu"] = {"fwd": 2.0 * b * nd * (c * 2 * c + c), "bwd": 2}
    taps = 2 * 56 * s["k"] + 1
    out["decimate"] = {"fwd": 2.0 * b * t * taps, "bwd": 1}
    kk = 2 * (s["n_mag"] - 1)
    nf = min((t + 2 * ((kk - 1) // 2) - (kk + hop - 1)) // hop + 1, tf)
    out["noise_fir"] = {"fwd": 2.0 * b * nf * hop * kk, "bwd": 1}
    out["noise_kernel_fft"] = {"fwd": b * tf * fft(kk), "bwd": 1}
    src = min(t, nf * hop)
    p = s["p"]
    if s["ws"] is None:
        t_end = min(src, (tf - 1) * hop + 1)
        out["allpole"] = {"fwd": 2.0 * p * b * t_end, "bwd": 2}
    else:
        ws = s["ws"]
        f = min((src + 2 * (ws // 2) - ws) // hop + 1, tf)
        t_end = (f - 1) * hop + ws - 2 * (ws // 2)
        out["allpole"] = {"fwd": 2.0 * p * b * f * ws, "bwd": 2}
    out["room_fir"] = {"fwd": 2.0 * b * t_end * s["room"], "bwd": 2}
    n = min(t_end, t)
    mss_fwd = mss_bwd = 0.0
    for nfft in s["n_ffts"]:
        lhop = int(nfft - nfft * 0.75)
        nfr = (n + 2 * (nfft // 2) - nfft) // lhop + 1
        mss_fwd += 2 * b * nfr * fft(nfft)     # the output and the target
        mss_bwd += b * nfr * fft(nfft)         # the output's only
    out["mss"] = {"fwd": mss_fwd, "bwd": mss_bwd / mss_fwd}
    return out


def train_step(config: Dict, batch: int, t: int) -> float:
    return sum(v["fwd"] * (1 + v["bwd"]) for v in
               parts(config, batch, t).values())


def resynthesis(config: Dict, batch: int, t: int) -> float:
    """A batched predict: every forward part but the loss."""
    return sum(v["fwd"] for k, v in parts(config, batch, t).items()
               if k != "mss")
