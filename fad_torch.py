#!/usr/bin/env python
"""Frechet Audio Distance per speaker between two directory trees (the
PyTorch/CUDA port's twin of ``fad.py``).

Usage:
    python fad_torch.py <ref_dir> <eval_dir> [--embedder logmel|vggish|dac]
        [--weights random|<path>] [--sr 24000] [--csv out.csv]
        [--device cpu]

The embedders: ``logmel`` (default; log-mel frame statistics over 5 s
windows at 50 % hop, not comparable to published FAD), ``vggish``
(``models/vggish.py``; ``--weights`` a torchvggish ``vggish-*.pth`` state
dict) and ``dac`` (``models/dac.py``, the reference's default;
``--weights`` a descript-audio-codec ``weights.pth``). Pretrained weights
are not in the repository: ``--weights random`` runs the architecture on
seeded weights, and its scores are not comparable to published FAD. The
embeddings run on the device, the Frechet statistics on the host. Runs
on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from golf_tpu_torch.core.device import resolve_device
from golf_tpu_torch.ops.stft import melspectrogram
from golf_tpu_torch.utils.wav import read_wav


class LogMelEmbedding:
    """5 s windows at 50 % hop (the reference's DAC24kModel windowing), the
    mean and standard deviation of each log-mel band over the window."""

    def __init__(self, sr: int = 24000, n_mels: int = 64,
                 window_secs: float = 5.0, device=None):
        self.sr = sr
        self.n_mels = n_mels
        self.window = int(window_secs * sr)
        self.device = resolve_device(device)

    def _logmel(self, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            mel = melspectrogram(
                torch.from_numpy(np.asarray(x, np.float32)[None]).to(
                    self.device), self.sr, 1024, 256, self.n_mels,
                power=2.0)
        return np.log(mel[0].cpu().numpy() + 1e-8)

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        assert sr == self.sr, (sr, self.sr)
        wav = wav.reshape(-1)
        hop = self.window // 2
        if len(wav) < self.window:
            wav = np.pad(wav, (0, self.window - len(wav)))
        outs = []
        for start in range(0, max(1, len(wav) - self.window + 1), hop):
            lm = self._logmel(wav[start:start + self.window])
            outs.append(np.concatenate([lm.mean(1), lm.std(1)]))
        return np.stack(outs)


def _state_dict(path: str) -> Dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def make_vggish_embedder(weights: str, device=None):
    """(VGGish embedder, whether its weights are real): a torchvggish state
    dict from a local path, or seeded weights for ``random``."""
    from golf_tpu_torch.models.vggish import VGGishEmbedder, random_state_dict
    if weights == "random":
        return VGGishEmbedder(random_state_dict(), device), False
    return VGGishEmbedder(_state_dict(weights), device), True


def make_dac_embedder(weights: str, device=None):
    """(DAC-24kHz embedder, whether its weights are real): a
    descript-audio-codec state dict from a local path (weight norm folded),
    or seeded weights for ``random``."""
    from golf_tpu_torch.models.dac import (DACEmbedder, random_state_dict,
                                           state_dict_from_dac)
    if weights == "random":
        return DACEmbedder(random_state_dict(), device), False
    return DACEmbedder(state_dict_from_dac(_state_dict(weights)), device), \
        True


def frechet_distance(mu1, s1, mu2, s2) -> float:
    from scipy import linalg
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1 @ s2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


def stats(embs: np.ndarray):
    return embs.mean(0), np.cov(embs, rowvar=False)


def make_embedder(name: str, weights: Optional[str], sr: int, device):
    """The embedder of ``--embedder`` and the line that labels it."""
    if name == "logmel":
        return LogMelEmbedding(sr=sr, device=device), (
            "# embedder: log-mel statistics - NOT comparable to published "
            "VGGish/DAC FAD numbers (pass --embedder vggish|dac --weights "
            "PATH for a real embedding)")
    title = {"vggish": "VGGish", "dac": "DAC-24kHz"}[name]
    if not weights:
        raise SystemExit(
            f"--embedder {name} needs --weights /path/to/state_dict.pth "
            f"(or --weights random for a smoke run): pretrained {title} "
            f"weights are not in the repository")
    make = make_dac_embedder if name == "dac" else make_vggish_embedder
    emb, real = make(weights, device)
    return emb, (f"# embedder: {title} (scores comparable to published "
                 f"{title}-FAD)" if real else
                 f"# embedder: {title} RANDOM-INIT - architecture smoke run "
                 f"only; scores NOT comparable to published FAD")


def speaker_scores(emb, ref_dir, eval_dir, suffix: str = ".wav"
                   ) -> Dict[str, float]:
    """FAD per first-level subdirectory of ``eval_dir`` against the same
    files under ``ref_dir``."""
    ref_dir, eval_dir = pathlib.Path(ref_dir), pathlib.Path(eval_dir)
    speakers = sorted({p.parent.relative_to(eval_dir)
                       for p in eval_dir.glob("**/*" + suffix)})
    scores: Dict[str, float] = {}
    for spk in speakers:
        ref_embs, eval_embs = [], []
        for p in sorted((eval_dir / spk).glob("*" + suffix)):
            wav, sr = read_wav(str(p))
            eval_embs.append(emb.embed(wav, sr))
            rp = ref_dir / spk / p.name
            if rp.exists():
                wav, sr = read_wav(str(rp))
                ref_embs.append(emb.embed(wav, sr))
        if not ref_embs:
            continue
        mu_r, s_r = stats(np.concatenate(ref_embs))
        mu_e, s_e = stats(np.concatenate(eval_embs))
        scores[str(spk)] = frechet_distance(mu_r, s_r, mu_e, s_e)
    return scores


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_dir")
    ap.add_argument("eval_dir")
    ap.add_argument("--suffix", default=".wav")
    ap.add_argument("--sr", type=int, default=24000)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--embedder", choices=["logmel", "vggish", "dac"],
                    default="logmel")
    ap.add_argument("--weights", default=None,
                    help="local path to a torchvggish / descript-audio-"
                         "codec state dict, or 'random' for an "
                         "architecture-only smoke run (required for "
                         "--embedder vggish|dac)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    emb, line = make_embedder(args.embedder, args.weights, args.sr, device)
    print(line)
    scores = speaker_scores(emb, args.ref_dir, args.eval_dir, args.suffix)
    vals = np.asarray(list(scores.values()))
    for spk, v in scores.items():
        print(f"{spk}: {v:.4f}")
    print(f"mean {vals.mean():.4f}  std {vals.std():.4f}  "
          f"min {vals.min():.4f}  max {vals.max():.4f}")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("speaker,fad\n")
            for spk, v in scores.items():
                f.write(f"{spk},{v}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
