"""VoiceAutoEncoder, the Interspeech24 analysis-by-synthesis task
(counterpart of ``golf_tpu.tasks.ae``): training, validation and predict.

encoder -> raw parameter groups -> the decoder's ctrl transforms ->
synthesizer -> the criterion (an MSS loss) plus the optional f0 and voicing
losses (masked above 50 Hz) and the coefficient-smoothness regulariser.
With ``train_with_true_f0`` the synthesis phase is the given f0 over the
sample rate: in training unvoiced frames take one random f0 in U(50, 500)
per item, in validation, test and predict 150 Hz. The test step adds the
mel-cepstral distortion (MCD) to the MSS loss. In a data-parallel step
(``parallel.mesh.data_parallel``) the random f0 is drawn over the global
batch and the masked f0 loss sums over the data group.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.sig import Sig, sig_where, true_divide
from ..models.ctrl import Synth
from ..models.enc import VocoderParameterEncoderInterface, full_layout
from ..ops.cepstrum import mcep
from ..ops.stft import spectrogram
from ..parallel.mesh import batch_sum, draw_rows
from ..utils import profiling


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The mean absolute error over the mask (over the global batch in a
    data-parallel step: both sums over the data group)."""
    n = torch.clamp(batch_sum(torch.sum(mask)), min=1)
    return batch_sum(torch.sum(torch.abs(pred - target) * mask)) / n


def f0_log_l1(f0_hat: torch.Tensor, f0: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    return masked_l1(torch.log(f0_hat + 1e-3), torch.log(f0 + 1e-3), mask)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def decode(decoder: Synth, params: Dict[str, Any],
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None):
    """The decoder's ctrl transforms on the raw ``*_params`` groups, then the
    synthesizer on them and the other entries (phase, voicing); returns
    (signal, ctrl parameters)."""
    ctrl = decoder.apply_ctrl(
        {k: v for k, v in params.items() if k.endswith("_params")})
    merged = ctrl | {k: v for k, v in params.items()
                     if not k.endswith("_params")}
    return decoder(**merged, generator=generator, noise=noise), ctrl


class VoiceAutoEncoder(nn.Module):
    def __init__(self, decoder: Synth,
                 encoder: VocoderParameterEncoderInterface,
                 criterion: Any = None, sample_rate: int = 24000,
                 detach_f0: bool = False, detach_voicing: bool = False,
                 train_with_true_f0: bool = True,
                 f0_loss_weight: float = 1.0,
                 voicing_loss_weight: float = 1.0,
                 coef_smooth_weight: float = 0.0):
        super().__init__()
        self.decoder = decoder
        self.encoder = encoder
        self.criterion = criterion
        self.sample_rate = sample_rate
        self.detach_f0 = detach_f0
        self.detach_voicing = detach_voicing
        self.train_with_true_f0 = train_with_true_f0
        self.f0_loss_weight = f0_loss_weight
        self.voicing_loss_weight = voicing_loss_weight
        self.coef_smooth_weight = coef_smooth_weight

    def _decode(self, params: Dict[str, Any],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                return_ctrl: bool = False):
        params = profiling.enter("decoder", params)
        y, ctrl = profiling.leave(
            "decoder", decode(self.decoder, params, generator, noise))
        return (y, ctrl) if return_ctrl else y

    def forward(self, x: Optional[Sig] = None, f0: Optional[Sig] = None,
                params: Optional[Dict[str, Any]] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        params = {} if params is None else dict(params)
        enc_params = None
        if x is not None:
            enc_params = self.encoder(x, f0=f0, train=train)
            params.update(enc_params)
            if "phase" not in params:
                params["phase"] = self.cycles(params["f0"])
            params.pop("f0", None)
            voicing_logits = params.pop("voicing_logits", None)
            if voicing_logits is not None:
                params["voicing"] = Sig(torch.sigmoid(voicing_logits.data),
                                        voicing_logits.hop)
        return self._decode(params, generator, noise), enc_params

    def cycles(self, f0_in_hz: Sig) -> Sig:
        """The phase increment a sample, f0 / sample_rate, divided on the
        card as on the CPU."""
        return Sig(true_divide(f0_in_hz.data, self.sample_rate),
                   f0_in_hz.hop)

    def phase_from_f0(self, f0_in_hz: Sig) -> Sig:
        return self.cycles(sig_where(Sig(f0_in_hz.data == 0, f0_in_hz.hop),
                                     150.0, f0_in_hz))

    def predict_step(self, x: Sig, f0_in_hz: Sig,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None):
        """(signal, encoder parameters); recorded as a step, the span
        ``predict``."""
        profiling.begin_step()
        with profiling.span("predict"):
            if self.train_with_true_f0:
                return self(x, f0_in_hz,
                            {"phase": self.phase_from_f0(f0_in_hz)},
                            generator=generator, noise=noise)
            return self(x, generator=generator, noise=noise)

    # -- training ----------------------------------------------------------
    def prepare_training(self, x: Sig, f0_in_hz: Sig, train: bool = True,
                         generator: Optional[torch.Generator] = None,
                         random_f0: Optional[torch.Tensor] = None):
        """Encoder pass and the phase/voicing preparation. ``random_f0``
        (B, 1) replaces the draw of the unvoiced frames' f0 from
        ``generator``, so a test can feed two implementations the same
        values."""
        params = self.encoder(
            x, f0=f0_in_hz if self.train_with_true_f0 else None,
            train=train)
        f0_hat = params.pop("f0", None)

        if self.train_with_true_f0:
            if random_f0 is None:
                random_f0 = 50.0 + 450.0 * draw_rows(
                    lambda shape: torch.rand(shape, generator=generator,
                                             device=f0_in_hz.data.device),
                    (f0_in_hz.shape[0], 1))
            phase = self.cycles(sig_where(
                Sig(f0_in_hz.data == 0, f0_in_hz.hop),
                Sig(random_f0.to(f0_in_hz.data).expand(f0_in_hz.shape),
                    f0_in_hz.hop),
                f0_in_hz))
        elif self.detach_f0:
            phase = self.cycles(Sig(f0_hat.data.detach(), f0_hat.hop))
        else:
            phase = self.cycles(f0_hat)
        params["phase"] = phase

        voicing_logits = params.pop("voicing_logits", None)
        if voicing_logits is not None:
            v = torch.sigmoid(voicing_logits.data)
            if self.detach_voicing:
                v = v.detach()
            params["voicing"] = Sig(v, voicing_logits.hop)
        return params, f0_hat, voicing_logits

    def aux_losses(self, f0_hat: Optional[Sig],
                   voicing_logits: Optional[Sig], ctrl_params: Dict,
                   f0_in_hz: Sig) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """The f0 and voicing losses (masked above 50 Hz) and the optional
        coefficient-smoothness regulariser. Returns (aux_total, metrics)."""
        aux = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        if self.coef_smooth_weight > 0 and \
                "end_filter_params" in ctrl_params:
            reg = 0.0
            for sig in ctrl_params["end_filter_params"]:
                d = sig.data if isinstance(sig, Sig) else sig
                # coefficient tensors (B, F, p) only: the exp-scaled gain
                # (B, F) would dominate the penalty
                if d.ndim >= 3 and d.shape[1] > 1:
                    reg = reg + torch.mean(torch.square(torch.diff(d, dim=1)))
            aux = aux + self.coef_smooth_weight * reg
            metrics["coef_smooth"] = reg
        if f0_hat is not None:
            target = f0_in_hz.data[:, ::f0_hat.hop][:, :f0_hat.shape[1]]
            pred = f0_hat.data[:, :target.shape[1]]
            f0_loss = f0_log_l1(pred, target, (target > 50).to(pred.dtype))
            aux = aux + f0_loss * self.f0_loss_weight
            metrics["f0_loss"] = f0_loss
        if voicing_logits is not None:
            vt = (f0_in_hz.data > 50).float()
            vt = vt[:, ::voicing_logits.hop][:, :voicing_logits.shape[1]]
            v_loss = bce_with_logits(voicing_logits.data[:, :vt.shape[1]],
                                     vt)
            aux = aux + v_loss * self.voicing_loss_weight
            metrics["voicing_loss"] = v_loss
        return aux, metrics

    def training_step(self, x: Sig, f0_in_hz: Sig, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      random_f0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one batch; ``generator`` draws the random f0
        and the noise unless ``random_f0`` and ``noise`` are given."""
        params, f0_hat, voicing_logits = self.prepare_training(
            x, f0_in_hz, train, generator, random_f0)
        x_hat, ctrl_params = self._decode(params, generator, noise,
                                          return_ctrl=True)
        t = min(x_hat.shape[1], x.shape[1])
        pred, target = profiling.enter("loss", (x_hat.data[:, :t],
                                                x.data[:, :t]))
        loss = profiling.leave("loss", self.criterion(pred, target))
        aux, metrics = self.aux_losses(f0_hat, voicing_logits, ctrl_params,
                                       f0_in_hz)
        loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    def validation_step(self, x: Sig, f0_in_hz: Sig,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        if self.train_with_true_f0:
            x_hat, enc_params = self(x, f0_in_hz,
                                     {"phase": self.phase_from_f0(f0_in_hz)},
                                     generator=generator)
        else:
            x_hat, enc_params = self(x, generator=generator)
        t = min(x_hat.shape[1], x.shape[1])
        loss = self.criterion(x_hat.data[:, :t], x.data[:, :t])
        enc_params = enc_params or {}
        aux, out = self.aux_losses(enc_params.get("f0"),
                                   enc_params.get("voicing_logits"), {},
                                   f0_in_hz)
        out["loss"] = loss + aux
        return out

    def test_step(self, x: Sig, f0_in_hz: Sig,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """MSS loss plus MCD (``golf_tpu``'s ``test_step``): mel-cepstra of
        order 34 at alpha 0.46 from 512-point magnitude spectrograms at hop
        sr/200, with two Newton iterations."""
        x_hat, _ = self.predict_step(x, f0_in_hz, generator=generator,
                                     noise=noise)
        t = min(x_hat.shape[1], x.shape[1])
        loss = self.criterion(x_hat.data[:, :t], x.data[:, :t])
        hop = self.sample_rate // 200

        def mceps(sig):
            amp = spectrogram(sig, 512, hop, win_length=512,
                              window="hanning", power=1.0, center=True)
            return mcep(amp.transpose(1, 2), 34, alpha=0.46, n_iter=2)

        mc_x = mceps(x.data[:, :t])
        mc_y = mceps(x_hat.data[:, :t])
        f = min(mc_x.shape[1], mc_y.shape[1])
        mcd = 10 * math.sqrt(2) / math.log(10) * torch.mean(
            torch.linalg.vector_norm(mc_x[:, :f] - mc_y[:, :f], dim=-1))
        return {"loss": loss, "mcd": mcd, "N": x.shape[0]}

    @torch.no_grad()
    def init_running_stats(self, x: Sig, f0_in_hz: Sig) -> None:
        """What ``golf_tpu``'s ``Trainer.init_state`` leaves behind: its
        init runs one train-mode forward on the first batch, which sets the
        encoder's running min/max (they start at +-inf) and leaves the batch
        norms' running statistics at their initial values. Without it an
        uninitialised predict divides by inf. Recorded as the span
        ``init_running_stats``."""
        with profiling.span("init_running_stats"):
            f0 = f0_in_hz if self.train_with_true_f0 else None
            self.encoder.backbone.features(x, f0, train=True)


def build_encoder(encoder_class_path: str, encoder_init_args: Dict,
                  split_sizes, args_keys) -> VocoderParameterEncoderInterface:
    """Encoder args split into interface args (learn_f0 etc.) and backbone
    kwargs; the backbone class comes from ``backbone_type``."""
    from ..config.registry import import_object

    args = dict(encoder_init_args)
    iface_keys = {"learn_voicing", "learn_f0", "f0_min", "f0_max"}
    iface_args = {k: args.pop(k) for k in list(args) if k in iface_keys}
    backbone_cls = import_object(args.pop("backbone_type",
                                          "models.unet.UNetEncoder"))
    sizes, _ = full_layout(split_sizes, args_keys,
                           iface_args.get("learn_voicing", False),
                           iface_args.get("learn_f0", True))
    accepted = inspect.signature(backbone_cls).parameters
    backbone = backbone_cls(
        out_channels=sum(s for group in sizes for s in group),
        **{k: v for k, v in args.items() if k in accepted})
    cls = import_object(encoder_class_path)
    return cls(backbone=backbone, split_sizes=split_sizes,
               args_keys=args_keys, **iface_args)


def build_voice_autoencoder(model_cfg: Dict,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> VoiceAutoEncoder:
    """Build the task from a ``model.init_args`` config subtree, on CUDA
    unless ``device`` says otherwise; recorded as the span
    ``build.model``."""
    with profiling.span("build.model"):
        return _build_voice_autoencoder(model_cfg, resolve_device(device))


def _build_voice_autoencoder(model_cfg: Dict, dev: torch.device
                             ) -> VoiceAutoEncoder:
    from ..config.registry import instantiate

    decoder = instantiate(model_cfg["decoder"])
    criterion = instantiate(model_cfg["criterion"]) \
        if model_cfg.get("criterion") else None
    split_sizes, args_keys = decoder.param_layout
    encoder = build_encoder(
        model_cfg.get("encoder_class_path",
                      "models.enc.VocoderParameterEncoderInterface"),
        model_cfg.get("encoder_init_args", {}), split_sizes, args_keys)
    task = VoiceAutoEncoder(
        decoder=decoder, encoder=encoder, criterion=criterion,
        sample_rate=model_cfg.get("sample_rate", 24000),
        detach_f0=model_cfg.get("detach_f0", False),
        detach_voicing=model_cfg.get("detach_voicing", False),
        train_with_true_f0=model_cfg.get("train_with_true_f0", True),
        f0_loss_weight=model_cfg.get("f0_loss_weight", 1.0),
        voicing_loss_weight=model_cfg.get("voicing_loss_weight", 1.0),
        coef_smooth_weight=model_cfg.get("coef_smooth_weight", 0.0))
    return task.to(dev)
