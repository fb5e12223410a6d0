"""Noise sources (counterpart of ``golf_tpu.models.noise``).

Each source draws its random field from a ``torch.Generator`` on the
reference signal's device, or takes it through ``noise``, so a test can
feed two implementations the same field: a normal field
(``StandardNormalNoise``), a uniform one in [0, 1) (``UniformNoise``), one
uniform in [-1, 1) a sequence (``SignFlipNoise``) or the (B, bands)
circular offsets of ``NoiseBand``. In a data-parallel step
(``parallel.mesh.data_parallel``) the normal field is drawn over the global
batch and sliced to this rank's rows; under time sharding the normal and
the uniform fields are drawn over the global (B, ``t_global``), the shape
of the unsharded reference that the decoder passes, and sliced to the
rank's rows and window.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from scipy import signal as scipy_signal

from ..core.sig import Sig
from ..parallel import seqpar
from ..parallel.mesh import draw_rows
from .ctrl import Controllable


class NoiseInterface(Controllable):
    pass


def _field(ref: Sig, shape, noise: Optional[torch.Tensor]
           ) -> Optional[torch.Tensor]:
    """The injected field on ``ref``'s device and dtype, checked against
    ``shape``; None when there is none."""
    if noise is None:
        return None
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise {tuple(noise.shape)} != {tuple(shape)}")
    return noise.to(ref.data)


class StandardNormalNoise(NoiseInterface):
    """Standard normal noise shaped like ``ref``, drawn from ``generator``
    (a ``torch.Generator`` on ``ref``'s device). ``noise`` replaces the draw
    with a given tensor of the same shape, so a test can feed two
    implementations the same field."""

    def forward(self, ref: Sig, *args,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                t_global: Optional[int] = None, **kwargs) -> Sig:
        env = seqpar.current()
        if env is not None and ref.ndim == 2:
            # time-sharded: drawn over the global (B, t_global), the
            # unsharded reference's shape (T unless given), and sliced, so
            # the field does not depend on the layout (``noise`` is global
            # too)
            return ref.new(seqpar.slice_global_rng(
                generator, (env.b_global, t_global or env.t_global), env,
                "normal", ref.dtype, ref.data.device, field=noise))
        z = _field(ref, ref.shape, noise)
        if z is None:
            z = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, dtype=ref.dtype,
                device=ref.data.device), ref.shape)
        return ref.new(z)

    def out_len(self, n: int, *params: Sig) -> int:
        return n


class UniformNoise(NoiseInterface):
    """Unit-variance uniform noise, (u - 0.5) * 2 sqrt(3) for u uniform in
    [0, 1) shaped like ``ref`` (``noise`` replaces u)."""

    def forward(self, ref: Sig, *args,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                t_global: Optional[int] = None, **kwargs) -> Sig:
        env = seqpar.current()
        if env is not None and ref.ndim == 2:
            # time-sharded: u over the global (B, t_global), sliced
            u = seqpar.slice_global_rng(
                generator, (env.b_global, t_global or env.t_global), env,
                "uniform", ref.dtype, ref.data.device, field=noise)
        else:
            u = _field(ref, ref.shape, noise)
            if u is None:
                u = torch.rand(ref.shape, generator=generator,
                               dtype=ref.dtype, device=ref.data.device)
        return ref.new((u - 0.5) * 2 * math.sqrt(3))

    def out_len(self, n: int, *params: Sig) -> int:
        return n


class SignFlipNoise(NoiseInterface):
    """The alternating pattern +1, -1, ... along time, times one sign a
    sequence: sign(u) of u uniform in [-1, 1) shaped like ``ref`` without
    its time axis (``noise`` replaces u; an exact 0 gives 0, as
    ``jnp.sign``)."""

    def forward(self, ref: Sig, *args,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **kwargs) -> Sig:
        u = _field(ref, ref.shape[:-1], noise)
        if u is None:
            u = torch.rand(ref.shape[:-1], generator=generator,
                           dtype=ref.dtype, device=ref.data.device) * 2 - 1
        t = torch.arange(ref.shape[-1], device=ref.data.device)
        alt = torch.where(t % 2 == 0, 1.0, -1.0).to(ref.dtype)
        return ref.new(torch.sign(u)[..., None] * alt)


def _design_noise_bands(n_filters: int, fs: int, attenuation: float,
                        normalize: bool, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The DDSP noise-band bank, host numpy and scipy as in ``golf_tpu``:
    Kaiser-designed low-pass, band-pass and high-pass filters, their
    magnitudes with phases from ``np.random.default_rng(seed)``, inverse
    FFT to loopable bands of a power-of-two length. Returns (bands
    (n_filters, length), centre frequencies), float32."""
    edges = np.linspace(0, fs / 2, n_filters + 1)
    bands = np.stack([edges[1:-2], edges[2:-1]], axis=1)

    centers = np.concatenate([
        [bands[0, 0] / 2], bands.mean(axis=1),
        [((fs / 2) + bands[-1, -1]) / 2]])

    def design(cutoff, pass_zero):
        if np.ndim(cutoff) > 0 and np.size(cutoff) > 1:
            bw = abs(cutoff[1] - cutoff[0])
        elif pass_zero:
            bw = float(cutoff)
        else:
            bw = abs(fs / 2 - float(cutoff))
        width = bw / (fs / 2) * 0.2
        n, beta = scipy_signal.kaiserord(ripple=attenuation, width=width)
        n = 2 * (n // 2) + 1
        return scipy_signal.firwin(n, cutoff, window=("kaiser", beta),
                                   scale=True, fs=fs, pass_zero=pass_zero)

    filters = [design(bands[0, 0], True)]
    for i in range(bands.shape[0]):
        filters.append(design(bands[i], False))
    filters.append(design(bands[-1, -1], False))

    max_len = max(len(f) for f in filters)
    noise_len = 2 ** math.ceil(math.log2(max_len))
    mat = np.stack([np.concatenate([np.zeros(noise_len - len(f)), f])
                    for f in filters])
    mag = np.abs(np.fft.rfft(mat, axis=-1))
    rng = np.random.default_rng(seed)
    phase = np.exp(1j * rng.uniform(0, 2 * np.pi, mag.shape))
    phase[:, 0] = 0
    phase[:, -1] = 0
    noise_bands = np.fft.irfft(mag * phase, axis=-1)
    if normalize:
        noise_bands = noise_bands / np.abs(noise_bands).max()
    return noise_bands.astype(np.float32), centers.astype(np.float32)


class NoiseBand(NoiseInterface):
    """A bank of ``n_filters`` precomputed loopable noise bands
    (``_design_noise_bands``), each read from its own random circular
    offset and mixed by exp(log_gain) at the frame hop.

    ``golf_tpu`` gathers the (B, bands, T) field, multiplies it by the
    gains upsampled to (B, T, bands) and sums the bands. Here the field is
    read as hop-long windows of the bands tiled to cover every offset, laid
    out (B, frames, bands, hop), and each frame's two neighbouring gain
    rows contract it in one batched matmul before the linear blend over the
    hop: the same sum without the upsampled gains and their product, whose
    (B, T, bands) copies at B = 64 x 2 s are 12.6 GB each."""

    def __init__(self, n_filters: int = 1024, fs: int = 44100,
                 attenuation: float = 50.0,
                 normalize_noise_bands: bool = True):
        super().__init__()
        self.n_filters = n_filters
        bands, centers = _design_noise_bands(n_filters, fs, attenuation,
                                             normalize_noise_bands)
        self.register_buffer("bands", torch.from_numpy(bands),
                             persistent=False)
        self.register_buffer("centers", torch.from_numpy(centers),
                             persistent=False)

    @property
    def split_sizes(self) -> Tuple[int, ...]:
        return (self.n_filters,)

    def ctrl(self, log_gain: Sig) -> Tuple[Sig, ...]:
        return (log_gain,)

    def forward(self, ref: Sig, log_gain: Sig,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, **kwargs) -> Sig:
        """``noise``: the (B, bands) integer offsets, replacing the draw of
        offsets uniform in [0, band length)."""
        b, t = ref.shape[0], ref.shape[1]
        num_bands, bands_len = self.bands.shape
        dev = ref.data.device
        off = torch.randint(0, bands_len, (b, num_bands), generator=generator,
                            device=dev) if noise is None else \
            _field(ref, (b, num_bands), noise).long()
        gain = torch.exp(log_gain.data)               # (B, frames, bands)
        hop = log_gain.hop
        # golf_tpu's broadcast: the gains upsampled to (frames - 1) hop + 1
        # samples, the field and the gains cut to the shorter
        n_out = min(t, (gain.shape[1] - 1) * hop + 1)
        frames = -(-n_out // hop)
        # rows f and f + 1 of each frame (the last row repeated past the
        # end: its weight is 0 there)
        rows = torch.cat([gain, gain[:, -1:]], dim=1)
        pair = torch.stack([rows[:, :frames], rows[:, 1:frames + 1]], dim=2)
        reps = -(-(bands_len + frames * hop) // bands_len)
        tiled = self.bands.to(ref.dtype).repeat(1, reps)
        windows = tiled.unfold(1, hop, 1)             # (bands, n, hop)
        start = off[:, None, :] + torch.arange(
            frames, device=dev)[None, :, None] * hop  # (B, frames, bands)
        field = windows[torch.arange(num_bands, device=dev), start]
        mixed = torch.matmul(pair, field)             # (B, frames, 2, hop)
        w = torch.arange(hop, dtype=ref.dtype, device=dev) / torch.full(
            (), hop, dtype=ref.dtype, device=dev)
        out = mixed[:, :, 0] * (1 - w) + mixed[:, :, 1] * w
        return Sig(out.reshape(b, frames * hop)[:, :n_out], 1)
