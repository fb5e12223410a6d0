"""VoiceAutoEncoder, the Interspeech24 analysis-by-synthesis task
(counterpart of ``golf_tpu.tasks.ae``), forward and predict.

encoder -> raw parameter groups -> the decoder's ctrl transforms ->
synthesizer. With ``train_with_true_f0`` the synthesis phase is the given
f0 (150 Hz where unvoiced) over the sample rate.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.sig import Sig, sig_where
from ..models.ctrl import Synth
from ..models.enc import VocoderParameterEncoderInterface, full_layout


class VoiceAutoEncoder(nn.Module):
    def __init__(self, decoder: Synth,
                 encoder: VocoderParameterEncoderInterface,
                 sample_rate: int = 24000, train_with_true_f0: bool = True):
        super().__init__()
        self.decoder = decoder
        self.encoder = encoder
        self.sample_rate = sample_rate
        self.train_with_true_f0 = train_with_true_f0

    def _decode(self, params: Dict[str, Any],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Sig:
        ctrl = self.decoder.apply_ctrl(
            {k: v for k, v in params.items() if k.endswith("_params")})
        merged = ctrl | {k: v for k, v in params.items()
                         if not k.endswith("_params")}
        return self.decoder(**merged, generator=generator, noise=noise)

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
                params["phase"] = params["f0"] / self.sample_rate
            params.pop("f0", None)
            voicing_logits = params.pop("voicing_logits", None)
            if voicing_logits is not None:
                params["voicing"] = Sig(torch.sigmoid(voicing_logits.data),
                                        voicing_logits.hop)
        return self._decode(params, generator, noise), enc_params

    def phase_from_f0(self, f0_in_hz: Sig) -> Sig:
        return sig_where(Sig(f0_in_hz.data == 0, f0_in_hz.hop), 150.0,
                         f0_in_hz) / self.sample_rate

    def predict_step(self, x: Sig, f0_in_hz: Sig,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None):
        if self.train_with_true_f0:
            return self(x, f0_in_hz, {"phase": self.phase_from_f0(f0_in_hz)},
                        generator=generator, noise=noise)
        return self(x, generator=generator, noise=noise)

    @torch.no_grad()
    def init_running_stats(self, x: Sig, f0_in_hz: Sig) -> None:
        """What ``golf_tpu``'s ``Trainer.init_state`` leaves behind: its
        init runs one train-mode forward on the first batch, which sets the
        encoder's running min/max (they start at +-inf) and leaves the batch
        norms' running statistics at their initial values. Without it an
        uninitialised predict divides by inf."""
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
    unless ``device`` says otherwise. The criterion is not built: the loss
    comes with the training slice."""
    from ..config.registry import instantiate

    dev = resolve_device(device)
    decoder = instantiate(model_cfg["decoder"])
    split_sizes, args_keys = decoder.param_layout
    encoder = build_encoder(
        model_cfg.get("encoder_class_path",
                      "models.enc.VocoderParameterEncoderInterface"),
        model_cfg.get("encoder_init_args", {}), split_sizes, args_keys)
    task = VoiceAutoEncoder(
        decoder=decoder, encoder=encoder,
        sample_rate=model_cfg.get("sample_rate", 24000),
        train_with_true_f0=model_cfg.get("train_with_true_f0", True))
    return task.to(dev)
