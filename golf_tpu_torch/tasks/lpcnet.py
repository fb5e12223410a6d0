"""LPCNet vocoder task (counterpart of ``golf_tpu.tasks.lpcnet``), the
ISMIR23 LPCNet baseline of ``cfg/lpcnet.yaml``.

Pre-emphasis -> log-mel features -> frame-rate net -> log area ratios ->
LPC coefficients, upsampled to the sample rate; the sample-rate dual GRU
predicts the mu-law excitation, trained by the interpolated cross-entropy
plus a regulariser, and (``match_lpc``) the L2 distance of the LAR to those
of the ground-truth LPC. ``generate`` resynthesises autoregressively, one
sample a step, drawing each excitation by Gumbel-max on ``logits *
temperature``, and de-emphasises the result with ``allpole_const``: B2 on
the card. ``run_lpcnet_test`` is the test protocol: the teacher-forced
metrics, then MSS and the f0's cents error of the autoregressive output.
There is no ``predict_step``, as in ``golf_tpu``.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.sig import Sig
from ..models.lpcnet import (SampleNet, mu_law_decode_continuous,
                             mu_law_encode_continuous)
from ..ops.allpole import allpole_const
from ..ops.cepstrum import lar2rc, lpc2rc, lpc_from_frames, rc2lar
from ..ops.dsp import fir_filt, get_window_fn, rc2lpc
from ..ops.stft import frame_signal
from .vocoder import ScaledLogMelSpectrogram


def preemphasis(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.cat([x[:, :1], x[:, 1:] - alpha * x[:, :-1]], dim=1)


def deemphasis(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """y[t] = x[t] + alpha y[t - 1]: ``allpole_const`` of order 1."""
    a = torch.full((x.shape[0], 1), -alpha, dtype=x.dtype, device=x.device)
    return allpole_const(x.contiguous(), a)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) of uniform u."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u))


def sample_excitation(logits: torch.Tensor, temperature: float,
                      gumbel: torch.Tensor) -> torch.Tensor:
    """A draw from softmax(logits * temperature) by Gumbel-max, as a float
    mu-law index. ``golf_tpu`` multiplies by the temperature too."""
    return torch.argmax(logits * temperature + gumbel,
                        dim=-1).to(logits.dtype)


class LPCNetVocoder(nn.Module):
    def __init__(self, frame_decoder: nn.Module, sample_decoder: SampleNet,
                 feature_trsfm: ScaledLogMelSpectrogram, lpc_order: int = 22,
                 quantization_channels: int = 256, alpha: float = 0.85,
                 window: str = "hanning", sample_rate: int = 24000,
                 hop_length: int = 120, gamma: float = 1.0,
                 match_lpc: bool = False, lpc_frame_length: int = 1024):
        super().__init__()
        self.frame_decoder = frame_decoder
        self.sample_decoder = sample_decoder
        self.feature_trsfm = feature_trsfm
        self.lpc_order = lpc_order
        self.quantization_channels = quantization_channels
        self.alpha = alpha
        self.window = window
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.gamma = gamma
        self.match_lpc = match_lpc
        self.lpc_frame_length = lpc_frame_length
        # the ground-truth LPC's analysis window, float32 as golf_tpu casts
        # it; a constant, not in checkpoints
        self.register_buffer(
            "lpc_window", torch.as_tensor(get_window_fn(window)(
                lpc_frame_length), dtype=torch.float32), persistent=False)

    def _frames_to_lpc(self, feats: Sig, train: bool):
        """The frame net's output f; its first ``lpc_order`` channels, times
        2, are the LAR; the whole of f conditions the sample net."""
        f = self.frame_decoder(feats, train=train)
        lar = f.data[..., :self.lpc_order] * 2
        return f, lar, rc2lpc(lar2rc(lar))

    def _prepare(self, x: torch.Tensor, train: bool):
        """(s, f, up_lpc, p, e, lar): the pre-emphasised signal, the tanh of
        the upsampled conditioning, the upsampled LPC, the prediction
        p[n] = sum_i a_i[n] s[n - i] (A(z) = 1 + sum a_i z^-i; 0 at n = 0),
        the excitation e = s + p, and the frame-rate LAR."""
        s = preemphasis(x, self.alpha)
        f_sig, lar, lpc = self._frames_to_lpc(
            self.feature_trsfm(x, train=train), train)
        f = torch.tanh(f_sig.reduce_hop_length().data)
        up_lpc = Sig(lpc, self.hop_length).reduce_hop_length().data
        t = min(up_lpc.shape[1], s.shape[1])
        s, up_lpc, f = s[:, :t], up_lpc[:, :t], f[:, :t]
        p = fir_filt(s[:, :-1], up_lpc[:, 1:])
        p = torch.cat([torch.zeros_like(p[:, :1]), p], dim=1)
        return s, f, up_lpc, p, s + p, lar

    def interp_loss(self, e_mu: torch.Tensor, logits: torch.Tensor):
        """The interpolated log-likelihood of the continuous index e_mu
        (B, T) under logits (B, T, Q), and the regulariser."""
        q = logits.shape[-1]
        lower = torch.clamp(torch.floor(e_mu).long(), 0, q - 2)
        p = torch.clamp(e_mu - lower, 0, 1)
        log_prob = F.log_softmax(logits, dim=-1)
        lp_low = torch.gather(log_prob, -1, lower[..., None])[..., 0]
        lp_up = torch.gather(log_prob, -1, lower[..., None] + 1)[..., 0]
        ll = torch.mean(lp_low * (1 - p) + lp_up * p)
        mu = self.quantization_channels - 1.0
        reg = torch.mean(torch.abs(e_mu - 0.5 * mu)) * math.log1p(mu) \
            / mu * 2
        return ll, reg

    def _gt_lar(self, x: torch.Tensor) -> torch.Tensor:
        """The LAR of the LPC of ``lpc_frame_length`` frames of x (hop
        ``hop_length``, not centred), the reflection coefficients clipped to
        +-0.999999 before ``rc2lar``'s own clip."""
        frames = frame_signal(x + 1e-7, self.lpc_frame_length,
                              self.hop_length, center=False)
        ga = lpc_from_frames(frames, self.lpc_order,
                             self.lpc_window.to(x.dtype))
        rc = lpc2rc(ga[..., 1:])
        return rc2lar(torch.clamp(rc, -0.999999, 0.999999))

    def training_step(self, x: Sig, f0_in_hz: Sig, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch. The sample net's previous
        excitation is e_mu plus N(0, 1) / Q; ``noise`` (B, T - 1), the
        N(0, 1) draw, replaces the one from ``generator``."""
        xd = x.data
        s, f, _, p, e, lar = self._prepare(xd, train)
        q = self.quantization_channels
        p_mu = mu_law_encode_continuous(p, q)
        e_mu = mu_law_encode_continuous(e, q)
        s_mu = mu_law_encode_continuous(s, q)
        if noise is None:
            noise = torch.randn(e_mu[:, :-1].shape, generator=generator,
                                device=xd.device, dtype=xd.dtype)
        logits = self.sample_decoder(f[:, 1:], p_mu[:, 1:], s_mu[:, :-1],
                                     e_mu[:, :-1] + noise / q)
        ll, reg = self.interp_loss(e_mu[:, 1:], logits)
        loss = -ll + self.gamma * reg
        metrics = {"ll": ll, "reg": reg}
        if self.match_lpc:
            with torch.no_grad():
                gt = self._gt_lar(xd)
            fmin = min(gt.shape[1], lar.shape[1])
            lar_l2 = torch.mean((lar[:, :fmin] - gt[:, :fmin]) ** 2)
            loss = loss + lar_l2
            metrics["lar_l2"] = lar_l2
        metrics["loss"] = loss
        return loss, metrics

    def validation_step(self, x: Sig, f0_in_hz: Sig,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        _, metrics = self.training_step(x, f0_in_hz, train=False,
                                        generator=generator)
        return metrics

    @torch.no_grad()
    def generate(self, x: Sig, temperature: float = 2.0,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Autoregressive resynthesis from x's own features (eval mode):
        ``sample`` on the conditioning and LPC of ``_prepare``, then
        de-emphasis. Returns (B, T)."""
        _, f, up_lpc, _, _, _ = self._prepare(x.data, train=False)
        return deemphasis(self.sample(f, up_lpc, temperature, generator,
                                      noise), self.alpha)

    @torch.no_grad()
    def sample(self, f: torch.Tensor, up_lpc: torch.Tensor,
               temperature: float = 2.0,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pre-emphasised signal, one sample a step from the sample-rate
        conditioning f (B, T, C) and LPC (B, T, p): the LPC prediction from
        the previous outputs, the sample net's step, an excitation drawn by
        Gumbel-max, the output clipped to [-1, 1]. ``noise`` (B, T, Q),
        Gumbel draws, replaces those from ``generator``."""
        q = self.quantization_channels
        net = self.sample_decoder
        b, t = f.shape[0], f.shape[1]
        order = up_lpc.shape[-1]
        lpc_flip = torch.flip(up_lpc, (-1,))
        # every output after ``order`` zeros: the window before step i is
        # hist[:, i:i + order], oldest first
        hist = f.new_zeros((b, order + t))
        e_mu = f.new_full((b,), (q - 1) * 0.5)
        states = (f.new_zeros((b, net.a_channels)),
                  f.new_zeros((b, net.b_channels)))
        for i in range(t):
            s_buf = hist[:, i:i + order]
            p = -torch.sum(s_buf * lpc_flip[:, i], dim=1)
            logits, states = net.sample_forward(
                f[:, i], mu_law_encode_continuous(p, q),
                mu_law_encode_continuous(s_buf[:, -1], q), e_mu, states)
            g = noise[:, i] if noise is not None else gumbel_noise(
                logits.shape, generator, logits.device, logits.dtype)
            e_mu = sample_excitation(logits, temperature, g)
            e = mu_law_decode_continuous(e_mu, q)
            hist[:, order + i] = torch.clamp(e + p, -1, 1)
        return hist[:, order:]

    @torch.no_grad()
    def init_running_stats(self, x: Sig, f0_in_hz: Sig) -> None:
        """The log-mel min/max that ``golf_tpu``'s train-mode init on the
        first batch leaves behind."""
        self.feature_trsfm(x.data, train=True)


def run_lpcnet_test(task: LPCNetVocoder, datamodule,
                    max_ar_batches: int = 4,
                    ar_dump_dir: Optional[str] = None) -> Dict[str, float]:
    """The LPCNet test protocol (``golf_tpu``'s): the teacher-forced metrics
    over the whole test split (eval mode), and on the first
    ``max_ar_batches`` batches the autoregressive resynthesis scored by MSS
    (n_ffts 1024, 2048, 512) and by the cents MAE of its f0, re-estimated by
    the host's DIO, against the dataset's track (both floored at 80 Hz).
    Returns the N-weighted ``avg_<metric>``, ``avg_ar_mss`` and
    ``avg_ar_f0_cents``. ``ar_dump_dir`` receives the first batch's first
    four outputs and references as wavs. The noise and the draws come from
    one generator seeded with 1234."""
    from ..loss.spec import MSSLoss
    from ..ops.dsp import freq2cent
    from ..utils.wav import write_wav
    from ..utils.world_lite import dio

    criterion = MSSLoss(n_ffts=[1024, 2048, 512], alpha=1.0,
                        window="hanning")
    device = next(task.parameters()).device
    generator = torch.Generator(device).manual_seed(1234)
    sr, hop = task.sample_rate, task.hop_length
    datamodule.setup("test")
    was_training = task.training
    task.eval()
    totals: Dict[str, float] = {}
    weight = ar_mss = ar_cents = ar_weight = 0.0
    with torch.inference_mode():
        for i, batch in enumerate(datamodule.test_dataloader()):
            x, f0 = (torch.from_numpy(np.asarray(a)).to(device)
                     for a in batch[:2])
            _, metrics = task.training_step(Sig(x, 1), Sig(f0, 1),
                                            train=False, generator=generator)
            n = x.shape[0]
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            weight += n
            if i >= max_ar_batches:
                continue
            x_hat = task.generate(Sig(x, 1), generator=generator)
            t = min(x.shape[1], x_hat.shape[1])
            ar_mss += float(criterion(x_hat[:, :t], x[:, :t])) * n
            xh = x_hat.cpu().numpy()
            if ar_dump_dir and i == 0:
                xs = x.cpu().numpy()
                for j in range(min(4, n)):
                    write_wav(os.path.join(ar_dump_dir, f"ar_{j:02d}.wav"),
                              xh[j, :t], sr)
                    write_wav(os.path.join(ar_dump_dir, f"ref_{j:02d}.wav"),
                              xs[j, :t], sr)
            f0_ref = f0.cpu().numpy()[:, ::hop]
            cents = []
            for j in range(n):
                f0_hat, _ = dio(xh[j].astype(np.float64), sr, f0_floor=65.0,
                                frame_period=1000 * hop / sr)
                m = min(len(f0_hat), f0_ref.shape[1])
                cents.append(float(np.mean(np.abs(
                    freq2cent(np.maximum(f0_hat[:m], 80))
                    - freq2cent(np.maximum(f0_ref[j, :m], 80))))))
            ar_cents += float(np.mean(cents)) * n
            ar_weight += n
    task.train(was_training)
    out = {("avg_" + k): v / max(weight, 1.0) for k, v in totals.items()}
    out["avg_ar_mss"] = ar_mss / max(ar_weight, 1.0)
    out["avg_ar_f0_cents"] = ar_cents / max(ar_weight, 1.0)
    return out


def build_lpcnet_vocoder(model_cfg: Dict,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> LPCNetVocoder:
    """Build the task from a ``model.init_args`` config subtree, on CUDA
    unless ``device`` says otherwise. The frame net (``Mel2Control`` of 80
    mels unless ``frame_decoder`` names one) outputs the sample net's
    ``condition_channels``; the feature transform takes the task's
    ``sample_rate``, ``hop_length`` and ``window`` unless it sets its own;
    the LPC frame length is read from ``lpc_frame_lengeth`` first, the
    reference's spelling."""
    from ..config.registry import instantiate
    from ..models.mel import Mel2Control

    dev = resolve_device(device)
    sd_args = dict((model_cfg.get("sample_decoder") or {})
                   .get("init_args") or {})
    sd_args.setdefault("quantization_channels",
                       model_cfg.get("quantization_channels", 256))
    sample_decoder = SampleNet(**sd_args)
    out_channels = sample_decoder.condition_channels

    fd_node = model_cfg.get("frame_decoder") or {}
    if "class_path" in fd_node:
        fd_node = copy.deepcopy(fd_node)
        fd_node["init_args"] = {**(fd_node.get("init_args") or {}),
                                "out_channels": out_channels}
        frame_decoder = instantiate(fd_node)
    else:
        frame_decoder = Mel2Control(out_channels, in_channels=80)

    feat_args = dict((model_cfg.get("feature_trsfm") or {})
                     .get("init_args") or {})
    feat_args.setdefault("sample_rate", model_cfg.get("sample_rate", 24000))
    feat_args.setdefault("hop_length", model_cfg.get("hop_length", 120))
    feat_args.setdefault("window", model_cfg.get("window", "hanning"))

    task = LPCNetVocoder(
        frame_decoder=frame_decoder, sample_decoder=sample_decoder,
        feature_trsfm=ScaledLogMelSpectrogram(**feat_args),
        lpc_order=model_cfg.get("lpc_order", 22),
        quantization_channels=model_cfg.get("quantization_channels", 256),
        alpha=model_cfg.get("alpha", 0.85),
        window=model_cfg.get("window", "hanning"),
        sample_rate=model_cfg.get("sample_rate", 24000),
        hop_length=model_cfg.get("hop_length", 120),
        gamma=model_cfg.get("gamma", 1.0),
        match_lpc=model_cfg.get("match_lpc", False),
        lpc_frame_length=model_cfg.get(
            "lpc_frame_lengeth", model_cfg.get("lpc_frame_length", 1024)))
    return task.to(dev)
