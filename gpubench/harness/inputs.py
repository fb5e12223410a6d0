"""What the benchmark makes from ``--seed`` and hands to the program and
to the reference alike: the weights, and the pool of input batches.

Weights: one draw of N(0, 1) on the device for every parameter of the
reference's ``param_spec``, each leaf ``mean + std * z`` of its slice.

Traffic: the traffic file's synthetic voices (a harmonic source on a
smooth random f0 contour with unvoiced gaps, plus a little noise, peak
normalised), the fields the configuration's task takes beyond them (the
GOLF decoder's noise field), and in training the f0 that unvoiced frames
take, all drawn on the device in a few large calls from generators seeded
by ``--seed``. Every seed makes the same shapes; only the values differ.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .spec import FIELDS

# streams of one seed: the weights, the voices, the noise, the dropout
_STREAMS = {"weights": 0, "voices": 1, "noise": 2, "dropout": 3}


def stream_seed(seed: int, stream: str, k: int = 0) -> int:
    """A generator seed of the stream ``stream`` (and its k-th draw) of
    ``seed``, below 2**63."""
    return (seed * 4 + _STREAMS[stream] + 1_000_003 * k) % (1 << 63)


def generator(seed: int, stream: str, device, k: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, k))


def draw_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor for every (name, shape, std, mean) of
    ``spec``."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    z = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                    device=device)
    out, ofs = {}, 0
    for (name, shape, std, mean), n in zip(spec, sizes):
        out[name] = (z[ofs:ofs + n].view(shape) * std + mean).contiguous()
        ofs += n
    return out


def voices(n: int, t: int, sr: int, v: Dict, gen: torch.Generator,
           device) -> tuple:
    """n voices of t samples: (x, f0) float32 (n, t), f0 in Hz, 0 where
    unvoiced. ``v``: the traffic file's ``voice`` section."""
    knots = v["knots"]
    lo, hi = v["f0_range"]
    u = torch.linspace(0, knots - 1, t, device=device, dtype=torch.float64)
    idx = torch.clamp(torch.floor(u), 0, knots - 2).long()
    frac = u - idx

    def contour(values):
        return values[:, idx] * (1 - frac) + values[:, idx + 1] * frac

    f0 = contour(lo + (hi - lo) * torch.rand(
        (n, knots), generator=gen, device=device, dtype=torch.float64))
    voiced = contour(torch.rand((n, knots), generator=gen, device=device,
                                dtype=torch.float64)) > v["voiced_above"]
    f0 = torch.where(voiced, f0, 0.0)
    phase = torch.cumsum(f0 / sr, dim=1)
    x = torch.zeros_like(phase)
    for k in range(1, v["harmonics"] + 1):
        x += torch.sin(2 * math.pi * k * phase) / k
    x = x * voiced + v["noise"] * torch.randn(
        (n, t), generator=gen, device=device, dtype=torch.float64)
    x = x * (v["peak"] / torch.clamp(x.abs().amax(dim=1, keepdim=True),
                                     min=1e-6))
    return x.float(), f0.float()


def field_shape(shape: List[str], t: int) -> tuple:
    """A field's shape after the rows: ``clip`` is ``t``, ``clip-<k>``
    ``t - k``."""
    def dim(d):
        name, _, less = d.partition("-")
        if name != "clip":
            raise ValueError(f"a field's dimension {d!r} is not clip or "
                             f"clip-<k>")
        return t - int(less or 0)
    return tuple(dim(d) for d in shape)


def pool(traffic: Dict, seed: int, device,
         fields: Optional[Dict[str, Dict]] = None
         ) -> List[Dict[str, torch.Tensor]]:
    """The traffic file's ``pool`` batches: each a dict of x, f0, the
    configuration's ``fields`` (``spec.Parts``; by default a noise field
    (B, T)), each one N(0, 1) draw over the pool in the order given, and
    (training) random_f0."""
    if fields is None:
        fields = FIELDS
    b = traffic["batch"]
    sr = traffic["sample_rate"]
    t = int(round(traffic["seconds"] * sr))
    n = traffic["pool"]
    x, f0 = voices(n * b, t, sr, traffic["voice"],
                   generator(seed, "voices", device), device)
    gen = generator(seed, "noise", device)
    drawn = {name: torch.randn((n * b,) + field_shape(f["shape"], t),
                               generator=gen, device=device)
             for name, f in fields.items()}
    out = []
    for i in range(n):
        rows = slice(i * b, (i + 1) * b)
        batch = {"x": x[rows].contiguous(), "f0": f0[rows].contiguous()}
        batch.update({name: v[rows].contiguous()
                      for name, v in drawn.items()})
        if "random_f0" in traffic:
            lo, hi = traffic["random_f0"]
            batch["random_f0"] = lo + (hi - lo) * torch.rand(
                (b, 1), generator=gen, device=device)
        out.append(batch)
    return out
