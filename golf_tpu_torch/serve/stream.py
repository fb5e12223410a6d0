"""Stateful chunked streaming synthesis for the GOLF-ss decoder (counterpart
of ``golf_tpu.serve.stream``).

A stream is synthesised chunk by chunk with constant memory, and every
emitted sample equals the offline decoder's on the same ctrl and noise up
to float32 rounding:

* the finite-memory stages (wavetable lookup, the oversampled decimation
  FIR, the zero-phase noise-shaping frame convolution) are recomputed on a
  sliding [prev | cur | next] chunk window and only the central chunk is
  kept: every FIR and overlap-add reach stays inside the window;
* the two unbounded-memory pieces carry explicit state: the wrapped phase
  offset of the oscillator (mod 1, in float64) and the all-pole filter's
  state, the
  last p outputs (``ops.allpole.allpole_stream``, on the card the
  time-varying kernel's forward entry with an initial state);
* the strictly causal room filter carries an input tail of (length - 1)
  samples.

Chunk c is emitted on push c + 2 (the window needs the next chunk, and the
wavetable's row interpolation one ctrl row beyond it): the algorithmic
latency is two chunks, 200 ms at 2400 samples and 24 kHz. ``flush`` drains
the last two chunks with edge-held ctrl rows and phase.

Supported topology: ``SourceFilterSynth`` with a glottal-flow table
oscillator that takes ``phase_offset``, an LTV FIR noise filter, the
sample-wise ``LTVMinimumPhaseFilterPrecise`` end filter (GOLF-ss) and an
optional ``LTIAcousticFilter``. PyTorch runs eagerly, so each push is a
sequence of launches on the stream's device; the buffers stay there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.sig import Sig
from ..models.filters import LTVMinimumPhaseFilterPrecise
from ..ops.allpole import allpole_stream

_BUF_KEYS = ("phase", "noise", "tw", "nf", "gain", "lpc")
_CTRL_ROWS = (("tw", "harm_oscillator_params", 0),
              ("nf", "noise_filter_params", 0),
              ("gain", "end_filter_params", 0),
              ("lpc", "end_filter_params", 1))


def chunk_ctrl(ctrl: Dict[str, Tuple[Sig, ...]], c: int, chunk: int,
               rest: bool = False) -> Dict[str, Tuple[Sig, ...]]:
    """The rows of chunk c of the streamed ctrl kinds of an applied ctrl
    (each Sig at its own hop: chunk / hop rows a chunk), or with ``rest``
    every row from chunk c on (what ``flush`` takes after c full
    chunks)."""
    out = {}
    for _, key, _ in _CTRL_ROWS:
        if key in ctrl and key not in out:
            out[key] = tuple(
                Sig(s.data[:, c * (chunk // s.hop):
                           None if rest else (c + 1) * (chunk // s.hop)],
                    s.hop) for s in ctrl[key])
    return out


def _device_of(module: nn.Module) -> torch.device:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return torch.device("cpu")


class GOLFStream:
    """Streaming synthesiser: one instance per stream, or per batch of
    streams in lock step.

    Each push takes the decoder's applied ctrl for one chunk (the output of
    ``decoder.apply_ctrl`` sliced to the chunk's rows: noise-filter
    log-magnitudes and end-filter (gain, lpc) at the ctrl hop, table
    weights at ``hop_rate`` times it; each Sig carries its hop, and the
    first push fixes them), the chunk's per-sample normalised frequency
    ``phase`` (B, chunk), and optionally its noise (B, chunk), which is
    otherwise drawn from a ``torch.Generator`` seeded with ``seed``.
    ``push`` returns the (B, chunk) audio of chunk ``pushes - 3`` on the
    decoder's device, or None for the first two pushes.
    """

    def __init__(self, decoder: nn.Module, chunk: int = 2400, seed: int = 0):
        if type(decoder.end_filter) is not LTVMinimumPhaseFilterPrecise:
            raise NotImplementedError(
                f"GOLFStream streams the sample-wise "
                f"LTVMinimumPhaseFilterPrecise end filter (GOLF-ss) only, "
                f"not {type(decoder.end_filter).__name__}")
        self.decoder = decoder
        self.chunk = chunk
        self.device = _device_of(decoder)
        self.generator = torch.Generator(self.device).manual_seed(seed)

        osc = decoder.harm_oscillator
        self.oversampling = getattr(osc, "oversampling", 1)
        self.hop_rate = getattr(osc, "hop_rate", 1)
        self._hops: Optional[Dict[str, int]] = None   # buffer key -> hop
        self.p = decoder.end_filter.lpc_order
        room = decoder.room_filter
        self.room_len = getattr(room, "length", 1) if room is not None else 1
        if chunk <= max(self.p, self.room_len):
            raise ValueError(f"chunk {chunk} must exceed the order {self.p} "
                             f"and the room filter's length {self.room_len}")
        if decoder.subtract_harmonics and decoder.noise_filter is None:
            raise ValueError("subtract_harmonics needs a noise filter")

        self._bufs: Dict[str, List[torch.Tensor]] = {k: [] for k in _BUF_KEYS}
        self._base = 0          # chunk index of _bufs[*][0]
        self._tail: Dict[str, torch.Tensor] = {}   # leftover ctrl rows
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._n_pushed = 0
        self._emitted = 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _step(self, first: bool, phase_w, noise_w, tw_rows, nf_rows,
              gain_rows, lpc_rows, offset, zi, room_tail):
        """One window. ``first``: the window is [cur | next] and starts at
        the stream's first sample, so the modules' own edge handling
        reproduces the offline start; otherwise [prev | cur | next] with
        the central chunk in the middle."""
        dec = self.decoder
        c = self.chunk
        central0 = 0 if first else c
        hop = self._hops["gain"]

        # harmonic source over the window, continued by the phase offset
        off = None if first else Sig(offset.float()[:, None], 1)
        harm = dec.harm_oscillator(Sig(phase_w, 1),
                                   Sig(tw_rows, self._hops["tw"]),
                                   phase_offset=off)
        # noise branch over the window
        nf = dec.noise_filter(Sig(noise_w, 1), Sig(nf_rows, hop))
        t_mix = min(harm.steps, nf.steps)
        src = harm.data[:, :t_mix] + nf.data[:, :t_mix]
        if dec.subtract_harmonics:
            hf = dec.noise_filter(Sig(harm.data, 1), Sig(nf_rows, hop))
            src = src - hf.data[:, :t_mix]

        # the central chunk through the stateful all-pole, as
        # LTVMinimumPhaseFilterPrecise does it: gain and coefficients
        # upsampled over the window (align-corners), then sliced
        gain_up = Sig(gain_rows, hop).reduce_hop_length().data
        a_up = Sig(lpc_rows, hop).reduce_hop_length().data
        tt = min(t_mix, gain_up.shape[1], a_up.shape[1])
        if tt < central0 + c:
            raise RuntimeError(f"window of {tt} samples is shorter than "
                               f"{central0 + c}")
        x_c = (src[:, :tt] * gain_up[:, :tt])[:, central0:central0 + c]
        a_c = a_up[:, central0:central0 + c]
        y, zi_next = allpole_stream(x_c, a_c, zi)

        # causal room filter on [input tail | y]
        if dec.room_filter is not None and self.room_len > 1:
            ext = torch.cat([room_tail, y], dim=1)
            audio = dec.room_filter(Sig(ext, 1)).data[:, self.room_len - 1:]
            room_tail = ext[:, -(self.room_len - 1):]
        else:
            audio = y

        # the chunk-0 and chunk-1 windows both start at sample 0, so the
        # first step leaves the offset at 0; afterwards the next window
        # starts one chunk later, and the offset advances by the window's
        # first chunk of increments at the oversampled rate. The offset and
        # the chunk's sum are float64: golf_tpu sums in float32, whose
        # rounding (about ulp(15) a chunk of 9600 increments) accumulates
        # over pushes, where the offline phase's error hardly grows with
        # the length
        if not first:
            k = self.oversampling
            inc = Sig(phase_w / k, k).reduce_hop_length().data if k > 1 \
                else phase_w
            offset = torch.remainder(
                offset + inc[:, :c * k].double().sum(dim=1), 1)
        return audio, zi_next, room_tail, offset

    def _init_state(self, b: int) -> Dict[str, torch.Tensor]:
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=self.device)
        return {"offset": z(b).double(), "zi": z(b, self.p),
                "room_tail": z(b, max(self.room_len - 1, 1))}

    def _check_hops(self, ctrl: Dict[str, Tuple[Sig, ...]]) -> None:
        """Fix the streamed kinds' hops on the first push, and hold every
        later push (and flush's tail rows) to them: the noise filter and
        the end filter at one ctrl hop, the table weights at ``hop_rate``
        times it, each dividing the chunk."""
        hops = {k: ctrl[key][i].hop for k, key, i in _CTRL_ROWS
                if key in ctrl and len(ctrl[key]) > i}
        if self._hops is None:
            hop = hops["gain"]
            want = {"tw": hop * self.hop_rate, "nf": hop, "gain": hop,
                    "lpc": hop}
            if hops != want:
                raise ValueError(f"ctrl hops {hops} disagree: the table "
                                 f"weights must be at {self.hop_rate} times "
                                 f"the others' hop, {want}")
            if self.chunk % want["tw"]:
                raise ValueError(f"chunk {self.chunk} must be a multiple of "
                                 f"the table ctrl hop {want['tw']}")
            self._hops = want
        elif any(h != self._hops[k] for k, h in hops.items()):
            raise ValueError(f"ctrl hops {hops} differ from the stream's "
                             f"{self._hops}")

    def _to_dev(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.float32, device=self.device)

    def push(self, ctrl: Dict[str, Tuple[Sig, ...]], phase: torch.Tensor,
             noise: Optional[torch.Tensor] = None
             ) -> Optional[torch.Tensor]:
        if "voicing" in ctrl:
            raise ValueError(
                "voicing-gated streaming is not supported yet: gate the "
                "harmonic branch upstream (zero the phase in unvoiced "
                "regions) or use the offline decoder")
        self._check_hops(ctrl)
        phase = self._to_dev(phase)
        b = phase.shape[0]
        if self._state is None:
            self._state = self._init_state(b)
        if noise is None:
            noise = torch.randn((b, self.chunk), generator=self.generator,
                                device=self.device)
        self._bufs["phase"].append(phase)
        self._bufs["noise"].append(self._to_dev(noise))
        for k, key, i in _CTRL_ROWS:
            self._bufs[k].append(self._to_dev(ctrl[key][i].data))
        self._n_pushed += 1
        if self._n_pushed < 3:
            return None
        return self._emit()

    def _buf(self, k: str, idx: int) -> torch.Tensor:
        return self._bufs[k][idx - self._base]

    def _emit(self) -> torch.Tensor:
        c_idx = self._emitted
        first = c_idx == 0
        lo = c_idx if first else c_idx - 1
        n = self._base + len(self._bufs["phase"])

        def cat(k):
            return torch.cat([self._buf(k, i) for i in range(lo, c_idx + 2)],
                             dim=1)

        # the table rows plus one row of interpolation look-ahead: the first
        # row of chunk c + 2 while streaming; at the end the leftover ctrl
        # rows given to flush (the Downsampler's edge padding gives one more
        # table row, the offline lookup's last interpolation target), else
        # the last row held
        if c_idx + 2 < n:
            extra = self._buf("tw", c_idx + 2)[:, :1]
        elif "tw" in self._tail:
            extra = self._tail["tw"][:, :1]
        else:
            extra = self._buf("tw", n - 1)[:, -1:]
        st = self._state
        audio, zi, room_tail, offset = self._step(
            first, cat("phase"), cat("noise"),
            torch.cat([cat("tw"), extra], dim=1), cat("nf"), cat("gain"),
            cat("lpc"), st["offset"], st["zi"], st["room_tail"])
        self._state = {"offset": offset, "zi": zi, "room_tail": room_tail}
        self._emitted += 1
        # the next emit (chunk c_idx + 1) needs chunks >= c_idx
        while self._base < self._emitted - 1:
            for k in _BUF_KEYS:
                self._bufs[k].pop(0)
            self._base += 1
        return audio

    def flush(self, tail_ctrl: Optional[Dict[str, Tuple[Sig, ...]]] = None
              ) -> torch.Tensor:
        """Drain the two pending chunks.

        ``tail_ctrl``: the ctrl rows past the last full chunk (ctrl frame
        counts generally exceed T / hop), which the offline decoder takes as
        the last blocks' interpolation targets; kinds not given are held at
        their last row. The phase past the end is held too, not set to a
        constant: equal energy scales the source by rsqrt(phase), so a small
        pad phase would make the pad far louder than the signal, and its
        rounding, spread over the window by the decimator, would swamp the
        last chunk. Samples past the offline decoder's support are
        edge-padded values."""
        if self._n_pushed == 0 or self._emitted >= self._n_pushed:
            return torch.zeros((1, 0), device=self.device)
        if tail_ctrl:
            self._check_hops(tail_ctrl)
            for k, key, i in _CTRL_ROWS:
                if key in tail_ctrl and len(tail_ctrl[key]) > i:
                    self._tail[k] = self._to_dev(tail_ctrl[key][i].data)
        outs = []
        if self._emitted < self._n_pushed - 1:
            outs.append(self._emit())        # chunk N - 2: all inputs real
        b = self._bufs["phase"][0].shape[0]

        def pad_rows(k):
            last = self._bufs[k][-1]
            rows = self._tail.get(k, last[:, :0])
            rpc = last.shape[1]
            if rows.shape[1] < rpc:
                hold = rows[:, -1:] if rows.shape[1] else last[:, -1:]
                rows = torch.cat(
                    [rows] + [hold] * (rpc - rows.shape[1]), dim=1)
            return rows[:, :rpc]

        # chunk N - 1: a virtual next chunk of held phase, zero noise and
        # the tail ctrl rows
        padded = {k: pad_rows(k) for k in ("tw", "nf", "gain", "lpc")}
        self._bufs["phase"].append(
            self._bufs["phase"][-1][:, -1:].expand(b, self.chunk))
        self._bufs["noise"].append(torch.zeros((b, self.chunk),
                                               device=self.device))
        for k, v in padded.items():
            self._bufs[k].append(v)
        outs.append(self._emit())
        return torch.cat(outs, dim=1)
