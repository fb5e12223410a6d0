"""The GOLF voice autoencoder of the Interspeech 2024 recipe in plain
PyTorch: the benchmark's reference for the port's training step and batch
resynthesis.

It reads the configuration file's ``model`` section (``cfg/ae/vctk.yaml``
with ``golf.yaml`` or ``golf-precise.yaml``) and implements it from the
published description: a log power spectrogram normalised by a running
min/max, a conv pyramid (Conv2d, batch norm, ReLU, max-pool over
frequency), a 3-layer BiLSTM, LayerNorm and a linear head; the decoder's
controls (a pooled GLU for the wavetable index, exp gains, reflection
coefficients through the step-up recursion); the glottal-flow wavetable
oscillator at 4x oversampling with equal energy and a Kaiser-sinc
decimation; Gaussian noise through a frame-wise zero-phase FIR; the
sample-wise (GOLF-ss) or frame-wise (GOLF-ff) all-pole end filter; the
learned causal room filter; the multi-scale spectral loss; clipped Adam.

Parameters live in a dict keyed by the names of the port's state dict, so
the benchmark can hand both the same weights; the LSTM runs as
``nn.LSTM`` through ``torch.func.functional_call`` (cuDNN on the card, the
native loop on the CPU), its dropout drawn from the default generators. The
all-pole recursions run in float64 (``allpole.py``); everything else runs
in the tensors' float32, with TF32 as ``precision`` sets it. Nothing here
imports the program or JAX, and nothing is read from the program.

The harness calls it through the interface every reference module has
(``gpubench/README.md``): ``param_spec``, ``train_readings``, ``outputs``,
``KEEP`` and ``NUMBERS``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import allpole
from .lf import glottal_table

Spec = List[Tuple[str, Tuple[int, ...], float, float]]


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 for matmuls and cuDNN on (the control) or off (the configured
    float32), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def hann(n: int, device) -> torch.Tensor:
    """The periodic Hann window ("hanning" in the recipe)."""
    return torch.hann_window(n, periodic=True, dtype=torch.float32,
                             device=device)


def upsample(x: torch.Tensor, k: int) -> torch.Tensor:
    """Linear interpolation along dim 1 onto (n - 1) k + 1 points, point i
    at input coordinate i / k."""
    if k == 1:
        return x
    n = x.shape[1]
    w = torch.arange(k, dtype=x.dtype, device=x.device) / k
    shape = (1, 1, k) + (1,) * (x.ndim - 2)
    w = w.reshape(shape)
    left, right = x[:, :-1, None], x[:, 1:, None]
    seg = (left * (1 - w) + right * w).reshape(x.shape[0], (n - 1) * k,
                                                *x.shape[2:])
    return torch.cat([seg, x[:, -1:]], dim=1)


def rc2lpc(rc: torch.Tensor) -> torch.Tensor:
    """Reflection coefficients (..., p) -> a_1..a_p of A(z) = 1 + sum a_i
    z^-i, by the step-up recursion a_i' = a_i + k_n a_{n-i}, a_n' = k_n."""
    a = rc[..., :1]
    for n in range(1, rc.shape[-1]):
        k = rc[..., n:n + 1]
        a = torch.cat([a + k * torch.flip(a, (-1,)), k], dim=-1)
    return a


def sinc_lowpass(q: int, zeros: int = 56, roll_off: float = 0.945
                 ) -> np.ndarray:
    """Kaiser-windowed (beta 14.77) sinc lowpass for decimation by q,
    cutoff roll_off of the new Nyquist, unit DC gain."""
    cutoff = roll_off * 0.5 / q
    half = zeros * q
    t = np.arange(-half, half + 1, dtype=np.float64)
    k = 2 * cutoff * np.sinc(2 * cutoff * t) * np.kaiser(2 * half + 1,
                                                          14.769656459379492)
    return (k / k.sum()).astype(np.float32)


class GOLF:
    """One configuration's model. ``cfg`` is the configuration file's
    dict."""

    def __init__(self, cfg: Dict, device):
        m = cfg["model"]
        enc = m["encoder_init_args"]
        dec = m["decoder"]["init_args"]
        harm = dec["harm_oscillator"]["init_args"]
        end = dec["end_filter"]
        self.device = torch.device(device)
        self.sr = m["sample_rate"]
        self.n_fft = enc["n_fft"]
        self.hop = enc["hop_length"]
        self.channels = list(enc["channels"])
        self.strides = list(enc["strides"])
        self.hidden = enc["lstm_hidden_size"]
        self.layers = enc["num_layers"]
        self.dropout = enc["dropout"]
        self.hop_rate = harm["hop_rate"]
        self.harm_ch = harm["in_channels"]
        self.k_os = harm["oversampling"]
        self.n_mag = dec["noise_filter"]["init_args"]["n_mag"]
        self.p = end["init_args"]["lpc_order"]
        self.frames = end["class_path"].endswith("LTVMinimumPhaseFilter")
        self.ws = end["init_args"].get("window_length", 0)
        self.room = dec["room_filter"]["init_args"]["length"]
        crit = m["criterion"]["init_args"]
        self.n_ffts = list(crit["n_ffts"])
        self.alpha = crit["alpha"]
        self.table = torch.from_numpy(glottal_table(
            points=harm["points"], min_rd=harm["min_R_d"],
            max_rd=harm["max_R_d"])).to(self.device)
        self.kaiser = torch.from_numpy(sinc_lowpass(self.k_os)).to(
            self.device)
        n_freq = self.n_fft // 2 + 1
        for s in self.strides:
            n_freq //= s
        self.lstm_in = n_freq * self.channels[-1] + 1
        self.head = self.harm_ch + self.n_mag + 1 + self.p
        self.lstm = nn.LSTM(self.lstm_in, self.hidden, self.layers,
                            batch_first=True, bidirectional=True,
                            dropout=self.dropout).to(self.device)
        self.opt = optimizer_settings(cfg)

    # -- parameters ------------------------------------------------------
    def param_spec(self) -> Spec:
        """(name, shape, std, mean) of every trained parameter: the
        benchmark draws each as mean + std * N(0, 1)."""
        c, h = self.harm_ch, self.hidden
        spec: Spec = [
            ("decoder.harm_oscillator.model.dense0.weight", (2 * c, c),
             1 / math.sqrt(c), 0.0),
            ("decoder.harm_oscillator.model.dense0.bias", (2 * c,), 0.02, 0.0),
            ("decoder.harm_oscillator.model.dense1.weight", (1, c),
             1 / math.sqrt(c), 0.0),
            ("decoder.harm_oscillator.model.dense1.bias", (1,), 0.02, 0.0),
            ("decoder.room_filter.kernel", (self.room - 1,), 0.01, 0.0),
        ]
        e = "encoder.backbone."
        cin = 1
        for i, (o, s) in enumerate(zip(self.channels, self.strides)):
            fan = cin * (2 * s + 1) * 3
            spec += [(f"{e}pyramid.convs.{i}.weight", (o, cin, 2 * s + 1, 3),
                      math.sqrt(2 / fan), 0.0),
                     (f"{e}pyramid.convs.{i}.bias", (o,), 0.02, 0.0),
                     (f"{e}pyramid.norms.{i}.weight", (o,), 0.1, 1.0),
                     (f"{e}pyramid.norms.{i}.bias", (o,), 0.1, 0.0)]
            cin = o
        std = 1 / math.sqrt(3 * h)
        for layer in range(self.layers):
            n_in = self.lstm_in if layer == 0 else 2 * h
            for sfx in ("", "_reverse"):
                spec += [
                    (f"{e}lstm.lstm.weight_ih_l{layer}{sfx}", (4 * h, n_in),
                     std, 0.0),
                    (f"{e}lstm.lstm.weight_hh_l{layer}{sfx}", (4 * h, h),
                     std, 0.0),
                    (f"{e}lstm.lstm.bias_hh_l{layer}{sfx}", (4 * h,), std,
                     0.0)]
        spec += [(f"{e}norm.weight", (2 * h,), 0.1, 1.0),
                 (f"{e}norm.bias", (2 * h,), 0.1, 0.0),
                 (f"{e}out_linear.weight", (self.head, 2 * h), 0.004, 0.0),
                 (f"{e}out_linear.bias", (self.head,), 0.05, 0.0)]
        return spec

    def new_state(self) -> Dict[str, torch.Tensor]:
        """The running min/max of the log spectrogram (+-inf until a
        train-mode pass) and the batch norms' running statistics (never
        updated by the recipe's eval path: mean 0, variance 1)."""
        return {"min": torch.tensor(float("inf"), device=self.device),
                "max": torch.tensor(float("-inf"), device=self.device)}

    # -- encoder -----------------------------------------------------------
    def features(self, st, x, f0, train: bool):
        win = hann(self.n_fft, x.device)
        spec = torch.stft(x, self.n_fft, self.hop, window=win, center=True,
                          pad_mode="reflect", return_complex=True).abs() ** 2
        f0_d = f0[:, ::self.hop][:, :spec.shape[2]]
        spec = spec[..., :f0_d.shape[1]]
        v = torch.log(spec[:, None] + 1e-8)
        if train:
            with torch.no_grad():
                st["min"] = torch.minimum(st["min"], v.min())
                st["max"] = torch.maximum(st["max"], v.max())
        return (v - st["min"]) / (st["max"] - st["min"]), f0_d

    def encode(self, w, st, x, f0, train: bool) -> torch.Tensor:
        e = "encoder.backbone."
        h, f0_d = self.features(st, x, f0, train)
        for i, s in enumerate(self.strides):
            # a train-mode batch norm subtracts the batch mean, so the
            # conv's bias cancels exactly: left out there, its gradient is
            # the exact zero rather than rounding
            bias = None if train else w[f"{e}pyramid.convs.{i}.bias"]
            h = F.conv2d(h, w[f"{e}pyramid.convs.{i}.weight"], bias,
                         padding=(s, 1))
            if train:
                mean = h.mean(dim=(0, 2, 3), keepdim=True)
                var = ((h - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
            else:
                # the running statistics as the recipe's eval path finds
                # them: mean 0, variance 1
                mean, var = 0.0, torch.ones((), device=h.device)
            g = w[f"{e}pyramid.norms.{i}.weight"][:, None, None]
            b = w[f"{e}pyramid.norms.{i}.bias"][:, None, None]
            h = (h - mean) / torch.sqrt(var + 1e-5) * g + b
            h = F.relu(h)
            n = h.shape[2] // s
            h = h[:, :, :n * s].reshape(h.shape[0], h.shape[1], n, s,
                                        h.shape[3]).amax(dim=3)
        bsz, c, fr, t = h.shape
        h = h.permute(0, 3, 2, 1).reshape(bsz, t, fr * c)
        h = torch.cat([h, torch.log1p(f0_d)[..., None]], dim=-1)
        lw = {k[len(e) + 10:]: v for k, v in w.items()
              if k.startswith(f"{e}lstm.lstm.")}
        for layer in range(self.layers):
            for sfx in ("", "_reverse"):
                lw[f"bias_ih_l{layer}{sfx}"] = torch.zeros(
                    4 * self.hidden, device=x.device)
        self.lstm.train(train)
        h = torch.func.functional_call(self.lstm, lw, (h,))[0]
        h = F.layer_norm(h, (h.shape[-1],), w[f"{e}norm.weight"],
                         w[f"{e}norm.bias"], eps=1e-6)
        return F.linear(h, w[f"{e}out_linear.weight"],
                        w[f"{e}out_linear.bias"])

    # -- decoder -----------------------------------------------------------
    def harmonic(self, w, h_harm, f0, fill):
        """The glottal-flow source at the sample rate; ``fill`` (B, 1) the
        f0 of unvoiced samples."""
        d = "decoder.harm_oscillator.model."
        k = self.hop_rate
        hp = F.pad(h_harm, (0, 0, k // 2, k // 2))
        nf = (hp.shape[1] - k) // k + 1
        pooled = hp[:, :nf * k].reshape(hp.shape[0], nf, k,
                                        hp.shape[2]).mean(dim=2)
        a, b = F.linear(pooled, w[d + "dense0.weight"],
                        w[d + "dense0.bias"]).chunk(2, dim=-1)
        sel = torch.sigmoid(F.linear(a * torch.sigmoid(b),
                                     w[d + "dense1.weight"],
                                     w[d + "dense1.bias"])[..., 0])
        n_tab = self.table.shape[0]
        raw = sel * (n_tab - 1)
        lo = torch.clamp(torch.floor(raw), 0, n_tab - 2)
        frac = (raw - lo)[..., None]
        lo = lo.long()
        tables = self.table[lo] * (1 - frac) + self.table[lo + 1] * frac

        # the phase: f0 / sr a sample in float32, correctly rounded (a
        # 0-dim divisor keeps CUDA from multiplying by a rounded
        # reciprocal), 4x oversampled, summed in float64
        f0 = torch.where(f0 == 0, fill.to(f0.dtype).expand_as(f0), f0)
        sr = torch.tensor(float(self.sr), dtype=f0.dtype, device=f0.device)
        inc = upsample(f0 / sr / self.k_os, self.k_os)
        wrapped = torch.remainder(torch.cumsum(inc.double(), dim=1),
                                  1.0).float()
        hop_os = self.hop * self.hop_rate * self.k_os
        n = wrapped.shape[1]
        blocks = -(-n // hop_os)
        if tables.shape[1] < blocks + 1:
            tables = torch.cat([tables, tables[:, -1:].expand(
                -1, blocks + 1 - tables.shape[1], -1)], dim=1)
        ph = F.pad(wrapped, (0, blocks * hop_os - n)).reshape(
            -1, blocks, hop_os)
        s = tables.shape[-1]
        col = ph * s
        c0 = torch.clamp(torch.floor(col), 0, s - 1)
        cw = col - c0
        c0 = c0.long()
        c1 = torch.where(c0 + 1 == s, 0, c0 + 1)
        rw = torch.arange(hop_os, dtype=ph.dtype, device=ph.device) / hop_os
        t0, t1 = tables[:, :blocks], tables[:, 1:blocks + 1]
        top = torch.gather(t0, 2, c0) * (1 - cw) + torch.gather(t0, 2, c1) * cw
        bot = torch.gather(t1, 2, c0) * (1 - cw) + torch.gather(t1, 2, c1) * cw
        y = (top * (1 - rw) + bot * rw).reshape(ph.shape[0], -1)[:, :n]
        y = y * torch.rsqrt(inc)
        half = (self.kaiser.shape[0] - 1) // 2
        return F.conv1d(F.pad(y, (half, half))[:, None],
                        self.kaiser[None, None], stride=self.k_os)[:, 0]

    def noise_filter(self, log_mag, noise):
        """Frame-wise zero-phase FIR: each frame's windowed, centred kernel
        correlated with the noise around that frame's hop."""
        kern = torch.fft.fftshift(torch.fft.irfft(torch.exp(log_mag), dim=-1),
                                  dim=-1)
        k = kern.shape[-1]
        kern = kern * hann(k, kern.device)
        pad = (k - 1) // 2
        frames = F.pad(noise, (pad, pad)).unfold(-1, k + self.hop - 1,
                                                 self.hop)
        f = min(frames.shape[1], kern.shape[1])
        b = noise.shape[0]
        out = F.conv1d(frames[:, :f].reshape(1, b * f, -1),
                       kern[:, :f].reshape(b * f, 1, k), groups=b * f)
        return out.reshape(b, f * self.hop)

    def end_filter(self, src, log_gain, logits):
        gain = upsample(torch.exp(log_gain), self.hop)
        a = rc2lpc(torch.tanh(logits))
        n = min(src.shape[1], gain.shape[1])
        exg = src[:, :n] * gain[:, :n]
        if not self.frames:
            a_up = upsample(a, self.hop)
            t = min(n, a_up.shape[1])
            return allpole.TimeVarying.apply(exg[:, :t].contiguous(),
                                             a_up[:, :t].contiguous())
        ws, hop, pad = self.ws, self.hop, self.ws // 2
        frames = F.pad(exg, (pad, pad)).unfold(-1, ws, hop)
        f = min(frames.shape[1], a.shape[1])
        b = exg.shape[0]
        y = allpole.Constant.apply(frames[:, :f].reshape(-1, ws).contiguous(),
                                   a[:, :f].reshape(-1, self.p).contiguous())
        win = hann(ws, y.device)
        length = (f - 1) * hop + ws
        out = F.fold((y.reshape(b, f, ws) * win).transpose(1, 2),
                     (1, length), (1, ws), stride=(1, hop))[:, 0, 0]
        norm = F.fold(win.expand(1, f, ws).transpose(1, 2), (1, length),
                      (1, ws), stride=(1, hop))[0, 0, 0]
        return out[:, pad:length - pad] / norm[pad:length - pad]

    def room_filter(self, w, x):
        taps = torch.cat([w["decoder.room_filter.kernel"],
                          torch.ones(1, device=x.device, dtype=x.dtype)])
        return F.conv1d(F.pad(x, (self.room - 1, 0))[:, None],
                        taps[None, None])[:, 0]

    def forward(self, w, st, x, f0, noise, fill, train: bool):
        """The resynthesised audio of x (B, T) with f0 (B, T) in Hz (0:
        unvoiced, which takes ``fill`` (B, 1)) and the noise field, and the
        encoder's output."""
        h = self.encode(w, st, x, f0, train)
        c = self.harm_ch
        harm = self.harmonic(w, h[..., :c], f0, fill)
        nf = self.noise_filter(h[..., c:c + self.n_mag], noise)
        n = min(harm.shape[1], nf.shape[1])
        src = harm[:, :n] + nf[:, :n]
        y = self.end_filter(src, h[..., c + self.n_mag],
                            h[..., c + self.n_mag + 1:])
        return self.room_filter(w, y), h

    def mss(self, pred, target):
        total = 0.0
        for n in self.n_ffts:
            hop = int(n - n * 0.75)
            win = hann(n, pred.device)
            sp, stt = (torch.stft(s, n, hop, window=win, center=True,
                                  pad_mode="reflect",
                                  return_complex=True).abs()
                       for s in (pred, target))
            total = total + torch.mean(torch.abs(sp - stt)) + self.alpha * \
                torch.mean(torch.abs(torch.log2(stt + 1e-8)
                                     - torch.log2(sp + 1e-8)))
        return total

    def loss(self, w, st, x, f0, noise, random_f0):
        y, _ = self.forward(w, st, x, f0, noise, random_f0, train=True)
        t = min(y.shape[1], x.shape[1])
        return self.mss(y[:, :t], x[:, :t])

    def predict(self, w, st, x, f0, noise):
        fill = torch.full((x.shape[0], 1), 150.0, device=x.device)
        return self.forward(w, st, x, f0, noise, fill, train=False)


def optimizer_settings(cfg: Dict) -> Dict:
    o = cfg.get("optimizer", {})
    return {"lr": o.get("lr", 1e-4), "clip": o.get("grad_clip", 0.5)}


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) behind a clip of the global
    gradient norm, skipping a step whose gradients are not finite."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], lr: float, clip: float):
        self.params, self.lr, self.clip = params, lr, clip
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply; returns the gradients as the update used them."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if not torch.isfinite(norm):
            return grads
        if self.clip and norm >= self.clip:
            grads = [g * (self.clip / norm).to(g.dtype) for g in grads]
        self.count += 1
        c1 = 1 - self.B1 ** self.count
        c2 = 1 - self.B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.B1).add_(g, alpha=1 - self.B1)
            nu.mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.EPS))
        return grads


# -- the interface ---------------------------------------------------------

# the submodules of the program whose forward output a resynthesis call
# keeps beside the audio (the encoder's: its head's rows), and the name of
# the number that compares each output, the audio first
KEEP = ("encoder.backbone",)
NUMBERS = ("out_l2", "head_gap")


def param_spec(cfg: Dict) -> Spec:
    """The configuration's trained parameters: (name, shape, std, mean)."""
    return GOLF(cfg, "cpu").param_spec()


def train_readings(cfg: Dict, weights: Dict[str, torch.Tensor],
                   batches: List[Dict], seeds: List[int], device,
                   rows: Optional[int] = None, tf32: bool = False) -> Dict:
    """The reference's first ``len(seeds)`` steps from ``weights``, the
    running min/max first set from batch 0, step k on batch k after
    ``torch.manual_seed(seeds[k])`` (the dropout masks): each step's loss,
    the per-leaf norm of the first gradient as Adam took it, and of each
    leaf's change over the steps. ``rows`` keeps the first rows of every
    batch only."""
    model = GOLF(cfg, device)

    def sel(t):
        return t if rows is None else t[:rows]

    with precision(tf32):
        names = [n for n, _, _, _ in model.param_spec()]
        w = {n: weights[n].detach().clone().requires_grad_(True)
             for n in names}
        opt = Adam([w[n] for n in names], model.opt["lr"], model.opt["clip"])
        st = model.new_state()
        model.features(st, sel(batches[0]["x"]), sel(batches[0]["f0"]),
                       train=True)
        losses, grad = [], None
        for k, seed in enumerate(seeds):
            b = batches[k % len(batches)]
            torch.manual_seed(seed)
            loss = model.loss(w, st, sel(b["x"]), sel(b["f0"]),
                              sel(b["noise"]), sel(b["random_f0"]))
            grads = torch.autograd.grad(loss, [w[n] for n in names],
                                        allow_unused=True,
                                        materialize_grads=True)
            used = opt.step(list(grads))
            losses.append(float(loss.detach()))
            if k == 0:
                grad = {n: float(torch.linalg.vector_norm(g.double()))
                        for n, g in zip(names, used)}
        change = {n: float(torch.linalg.vector_norm(
            (w[n].detach() - weights[n]).double())) for n in names}
    return {"loss": losses, "grad": grad, "change": change}


def outputs(cfg: Dict, weights: Dict[str, torch.Tensor], first: Dict,
            batches: Dict[int, Dict], device, tf32: bool = False) -> Dict:
    """The reference's resynthesis of each of ``batches`` (by index): the
    audio and the encoder's output."""
    model = GOLF(cfg, device)
    return {i: predict(model, weights, first, b, tf32=tf32)
            for i, b in batches.items()}


def predict(model: GOLF, weights: Dict[str, torch.Tensor], first: Dict,
            batch: Dict, tf32: bool = False):
    """The reference's resynthesis of ``batch`` after a train-mode pass of
    the features over ``first`` (the running min/max): (the audio, the
    encoder's output)."""
    with precision(tf32), torch.no_grad():
        st = model.new_state()
        model.features(st, first["x"], first["f0"], train=True)
        return model.predict(weights, st, batch["x"], batch["f0"],
                             batch["noise"])
