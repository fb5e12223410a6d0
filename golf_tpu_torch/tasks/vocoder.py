"""DDSPVocoder, the ISMIR23 mel-spectrogram vocoder (counterpart of
``golf_tpu.tasks.vocoder``).

Log-mel features normalised by running min/max buffers
(``ScaledLogMelSpectrogram``) -> encoder -> (f0, parameter groups, voicing)
-> harmonic-plus-noise decoder. The loss is MSS plus the masked L1 (with
``l1_loss_weight``), the log-f0 L1 and the voicing cross-entropy, with
switches that detach the f0 and the voicing; with ``train_with_true_f0``
the voiced frames synthesise from the given f0. With ``inverse_target``
(a ``SourceFilterSynth`` decoder) the losses live in the excitation
domain: the decoder's scaled source against the target through the end
filter's inverse. The test step resynthesises on the device, re-estimates
the f0 on the host (DIO) and scores its cents error; predict runs 6 s
chunks with 0.3 s linear crossfades.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.sig import Sig, true_divide
from ..models.ctrl import Synth
from ..models.sf import SourceFilterSynth
from ..models.enc import VocoderParameterEncoderInterface, _running_minmax
from ..ops.stft import melspectrogram
from .ae import bce_with_logits, build_encoder, decode, f0_log_l1


class ScaledLogMelSpectrogram(nn.Module):
    """log(mel + 1e-8) as (B, frames, n_mels), normalised by the running
    min/max buffers ``log_mel_min`` and ``log_mel_max`` (starting at +inf
    and -inf, updated in train mode and kept in checkpoints)."""

    def __init__(self, window: str = "hanning", sample_rate: int = 24000,
                 n_fft: int = 1024, hop_length: int = 240,
                 win_length: Optional[int] = None, n_mels: int = 80,
                 center: bool = True, f_min: float = 0.0,
                 f_max: Optional[float] = None, power: float = 2.0):
        super().__init__()
        self.window = window
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mels = n_mels
        self.center = center
        self.f_min = f_min
        self.f_max = f_max
        self.power = power
        self.register_buffer("log_mel_min", torch.tensor(float("inf")))
        self.register_buffer("log_mel_max", torch.tensor(float("-inf")))

    def forward(self, waveform: torch.Tensor, train: bool = False) -> Sig:
        mel = melspectrogram(
            waveform, self.sample_rate, self.n_fft, self.hop_length,
            self.n_mels, win_length=self.win_length, window=self.window,
            f_min=self.f_min, f_max=self.f_max, power=self.power,
            center=self.center)
        log_mel = torch.log(mel.transpose(-1, -2) + 1e-8)
        return Sig(_running_minmax(self, log_mel, train, "log_mel"),
                   self.hop_length)


class DDSPVocoder(nn.Module):
    def __init__(self, decoder: Synth,
                 encoder: VocoderParameterEncoderInterface,
                 feature_trsfm: ScaledLogMelSpectrogram, criterion: Any,
                 sample_rate: int = 24000, hop_length: int = 120,
                 detach_f0: bool = False, detach_voicing: bool = False,
                 train_with_true_f0: bool = False,
                 l1_loss_weight: float = 0.0, f0_loss_weight: float = 1.0,
                 voicing_loss_weight: float = 1.0,
                 inverse_target: bool = False):
        super().__init__()
        if inverse_target and not isinstance(decoder, SourceFilterSynth):
            raise NotImplementedError(
                f"inverse_target needs a SourceFilterSynth decoder, whose end "
                f"filter has an inverse mode; {type(decoder).__name__} "
                f"returns no inverse signal (golf_tpu fails there too)")
        self.decoder = decoder
        self.encoder = encoder
        self.feature_trsfm = feature_trsfm
        self.criterion = criterion
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.detach_f0 = detach_f0
        self.detach_voicing = detach_voicing
        self.train_with_true_f0 = train_with_true_f0
        self.l1_loss_weight = l1_loss_weight
        self.f0_loss_weight = f0_loss_weight
        self.voicing_loss_weight = voicing_loss_weight
        self.inverse_target = inverse_target

    def cycles(self, f0_in_hz: torch.Tensor) -> torch.Tensor:
        """The phase increment a sample, f0 / sample_rate, divided on the
        card as on the CPU."""
        return true_divide(f0_in_hz, self.sample_rate)

    def forward(self, feats: Sig, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """feats -> (f0, x_hat, voicing)."""
        params = self.encoder(feats, train=train)
        f0 = params.pop("f0")
        params["phase"] = Sig(self.cycles(f0.data), f0.hop)
        voicing_logits = params.pop("voicing_logits", None)
        if voicing_logits is not None:
            params["voicing"] = Sig(torch.sigmoid(voicing_logits.data),
                                    voicing_logits.hop)
        x_hat, _ = decode(self.decoder, params, generator, noise)
        return f0, x_hat, params.get("voicing")

    def training_step(self, x: Sig, f0_in_hz: Sig, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch; ``noise`` replaces the draw from
        ``generator``. The f0 track and its voiced mask (f0 > 50 Hz) are
        taken every ``hop_length`` samples and cut with the encoder's
        frames to the shorter of the two."""
        xd, f0d = x.data, f0_in_hz.data
        low_res_f0 = f0d[:, ::self.hop_length]
        mask = f0d > 50
        low_res_mask = mask[:, ::self.hop_length]

        feats = self.feature_trsfm(xd, train=train)
        params = self.encoder(feats, train=train)
        f0_hat = params.pop("f0")
        voicing_logits = params.pop("voicing_logits", None)

        min_len = min(f0_hat.shape[1], low_res_f0.shape[1])
        low_res_f0 = low_res_f0[:, :min_len]
        low_res_mask = low_res_mask[:, :min_len]
        f0_hat_d = f0_hat.data[:, :min_len]

        vl = voicing = None
        if voicing_logits is not None:
            vl = voicing_logits.data[:, :min_len]
            voicing = torch.sigmoid(vl.detach() if self.detach_voicing
                                    else vl)

        f0_dec = f0_hat_d.detach() if self.detach_f0 else f0_hat_d
        if self.train_with_true_f0:
            f0_dec = torch.where(low_res_mask, low_res_f0, f0_dec)
        params["phase"] = Sig(self.cycles(f0_dec), f0_hat.hop)
        if voicing is not None:
            params["voicing"] = Sig(voicing, voicing_logits.hop)

        if self.inverse_target:
            (x_hat, x_cmp), _ = decode(self.decoder,
                                       params | {"target": Sig(xd, 1)},
                                       generator, noise)
            x_hat, x_cmp = x_hat.data, x_cmp.data
        else:
            x_hat = decode(self.decoder, params, generator, noise)[0].data
            x_cmp = xd
        t = min(x_hat.shape[-1], x_cmp.shape[-1])
        x_hat, x_cmp = x_hat[:, :t], x_cmp[:, :t]
        m = mask[:, :t].to(x_hat.dtype)
        loss = self.criterion(x_hat, x_cmp)
        l1 = torch.sum(m * torch.abs(x_hat - x_cmp)) / torch.clamp(
            torch.sum(m), min=1)
        f0_loss = f0_log_l1(f0_hat_d, low_res_f0,
                            low_res_mask.to(f0_hat_d.dtype))
        metrics = {"l1_loss": l1, "f0_loss": f0_loss}
        if self.l1_loss_weight > 0:
            loss = loss + l1 * self.l1_loss_weight
        if self.f0_loss_weight > 0:
            loss = loss + f0_loss * self.f0_loss_weight
        if vl is not None:
            v_loss = bce_with_logits(vl, low_res_mask.to(vl.dtype))
            metrics["voicing_loss"] = v_loss
            # added unweighted, as golf_tpu (and its reference) do
            if self.voicing_loss_weight > 0:
                loss = loss + v_loss
        metrics["loss"] = loss
        return loss, metrics

    def validation_step(self, x: Sig, f0_in_hz: Sig,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        _, metrics = self.training_step(x, f0_in_hz, train=False,
                                        generator=generator)
        return metrics

    def test_forward(self, x: Sig, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> Sig:
        """Resynthesis from the waveform's own features."""
        feats = self.feature_trsfm(x.data, train=False)
        _, x_hat, _ = self(feats, generator=generator, noise=noise)
        return x_hat

    def predict_step(self, x: Sig, f0_in_hz: Optional[Sig] = None,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None):
        """One chunk; ``chunked_ola_predict`` runs long inputs."""
        return self.test_forward(x, generator, noise), None

    @torch.no_grad()
    def init_running_stats(self, x: Sig, f0_in_hz: Sig) -> None:
        """What ``golf_tpu``'s ``Trainer.init_state`` leaves behind: its init
        runs one train-mode step on the first batch, which sets the log-mel
        min/max (they start at +-inf). Without it an uninitialised predict
        divides by inf."""
        self.feature_trsfm(x.data, train=True)


def build_ddsp_vocoder(model_cfg: Dict,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> DDSPVocoder:
    """Build the task from a ``model.init_args`` config subtree, on CUDA
    unless ``device`` says otherwise. The feature transform takes the
    task's ``sample_rate``, ``hop_length`` and ``window`` unless it sets
    its own (``golf_tpu``'s argument linking)."""
    from ..config.registry import instantiate

    dev = resolve_device(device)
    decoder = instantiate(model_cfg["decoder"])
    criterion = instantiate(model_cfg["criterion"])
    split_sizes, args_keys = decoder.param_layout
    encoder = build_encoder(
        model_cfg.get("encoder_class_path",
                      "models.enc.VocoderParameterEncoderInterface"),
        model_cfg.get("encoder_init_args", {}), split_sizes, args_keys)

    feat_node = dict(model_cfg.get("feature_trsfm", {}))
    feat_args = dict(feat_node.get("init_args", feat_node))
    feat_args.setdefault("sample_rate", model_cfg.get("sample_rate", 24000))
    feat_args.setdefault("hop_length", model_cfg.get("hop_length", 120))
    feat_args.setdefault("window", model_cfg.get("window", "hanning"))
    feat_args.pop("class_path", None)

    task = DDSPVocoder(
        decoder=decoder, encoder=encoder,
        feature_trsfm=ScaledLogMelSpectrogram(**feat_args),
        criterion=criterion,
        sample_rate=model_cfg.get("sample_rate", 24000),
        hop_length=model_cfg.get("hop_length", 120),
        detach_f0=model_cfg.get("detach_f0", False),
        detach_voicing=model_cfg.get("detach_voicing", False),
        train_with_true_f0=model_cfg.get("train_with_true_f0", False),
        l1_loss_weight=model_cfg.get("l1_loss_weight", 0.0),
        f0_loss_weight=model_cfg.get("f0_loss_weight", 1.0),
        voicing_loss_weight=model_cfg.get("voicing_loss_weight", 1.0),
        inverse_target=model_cfg.get("inverse_target", False))
    return task.to(dev)


def chunked_ola_predict(apply_fn, x: np.ndarray, sample_rate: int,
                        chunk_secs: float = 6.0,
                        hop_secs: float = 5.7) -> np.ndarray:
    """Host-side 6 s / 0.3 s-overlap linear-crossfade OLA (host numpy,
    copied from ``golf_tpu``).

    apply_fn: (B, frame_length) -> (B, out_length) resynthesis callable.
    """
    frame_length = int(chunk_secs * sample_rate)
    hop_length = int(hop_secs * sample_rate)
    overlap = frame_length - hop_length

    t = x.shape[-1]
    xp = np.pad(x.reshape(-1), (0, frame_length))
    n_frames = (xp.shape[0] - frame_length) // hop_length + 1
    frames = np.stack([xp[i * hop_length: i * hop_length + frame_length]
                       for i in range(n_frames)])
    x_hat = np.asarray(apply_fn(frames))[:, :frame_length]
    if x_hat.shape[1] < frame_length:
        overlap = x_hat.shape[1] - hop_length
        frame_length = x_hat.shape[1]
    p = np.arange(overlap) / max(overlap, 1)

    ola = np.zeros(hop_length * (x_hat.shape[0] - 1) + frame_length)
    for i in range(x_hat.shape[0]):
        addon = x_hat[i].copy()
        if i:
            ola[i * hop_length: i * hop_length + overlap] *= 1 - p
            addon[:overlap] *= p
        ola[i * hop_length: i * hop_length + frame_length] += addon
    return ola[:t]


def run_vocoder_test(task: DDSPVocoder, datamodule,
                     noises: Optional[Sequence[torch.Tensor]] = None
                     ) -> Dict[str, float]:
    """The test split's MSS loss and f0 error: each batch is resynthesised
    on the task's device (eval mode) and scored by its criterion there; the
    f0 of each output is re-estimated on the host by DIO (float64, frames
    every ``hop_length`` samples) and its cents MAE taken against the
    dataset's track, both floored at 80 Hz. Returns the N-weighted
    ``avg_mss_loss`` and ``avg_f0_loss``. ``noises``, one field a batch,
    replaces the noise drawn from a generator seeded with 0."""
    from ..ops.dsp import freq2cent
    from ..utils.world_lite import dio

    sr, hop = task.sample_rate, task.hop_length
    device = next(task.parameters()).device
    generator = torch.Generator(device).manual_seed(0)
    datamodule.setup("test")
    was_training = task.training
    task.eval()
    totals = {"mss": 0.0, "f0_cents": 0.0}
    weight = 0.0
    with torch.inference_mode():
        for i, batch in enumerate(datamodule.test_dataloader()):
            x, f0_in_hz = batch[:2]
            xs = torch.from_numpy(np.asarray(x)).to(device)
            noise = None if noises is None else noises[i].to(device)
            x_hat = task.test_forward(Sig(xs, 1), generator, noise).data
            t = min(xs.shape[1], x_hat.shape[1])
            mss = float(task.criterion(x_hat[:, :t], xs[:, :t]))
            x_hat = x_hat.cpu().numpy()
            f0_ref = np.asarray(f0_in_hz)[:, ::hop]
            f0_hat = np.stack([
                dio(x_hat[j].astype(np.float64), sr, f0_floor=65.0,
                    frame_period=1000 * hop / sr)[0]
                for j in range(x_hat.shape[0])])
            f = min(f0_hat.shape[1], f0_ref.shape[1])
            fr = np.maximum(f0_ref[:, :f], 80)
            fh = np.maximum(f0_hat[:, :f], 80)
            cents = float(np.mean(np.abs(freq2cent(fh) - freq2cent(fr))))
            n = xs.shape[0]
            totals["mss"] += mss * n
            totals["f0_cents"] += cents * n
            weight += n
    task.train(was_training)
    return {"avg_mss_loss": totals["mss"] / weight,
            "avg_f0_loss": totals["f0_cents"] / weight}
