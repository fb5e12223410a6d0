"""Exact-causal streaming encoder (counterpart of
``golf_tpu.serve.enc_stream``).

Streams the ``UNetEncoder``-backed ``VocoderParameterEncoderInterface``
with exact forward state and a bounded backward look-ahead:

* the finite-receptive-field front (centred STFT, log, the static min/max
  normalisation, the conv pyramid with its eval-mode batch norms and time
  kernel 3 a layer) runs on sliding sample windows that cover every
  emitted row's receptive field, so each emitted conv row equals the
  offline encoder's; rows that would see the window's own padding are
  dropped, and the true stream start and end reproduce the offline padding;
* each LSTM layer's forward direction carries its (h, c) across pushes:
  exact;
* each backward direction runs over the pending rows from a zero carry at
  their right edge, so rows are held back ``lookahead`` frames; offline also
  starts the backward direction from zero at the utterance's end, so
  ``flush`` is exact, and mid-stream rows differ by what the backward
  forget gates have not yet forgotten (``backward_decay`` measures it);
* the LRU backbone (``use_lru``) streams with no structural look-ahead: the
  diagonal recurrence is causal, so its complex state is carried across
  pushes and emitted rows are final at once. Only the first emission's
  carry-in differs from offline, which predicts it from the utterance's
  last frame: the stream predicts it from its newest frame, after waiting
  ``lookahead`` frames for context, and the difference decays as
  |lambda|^t. A one-push utterance equals offline;
* the env-features front (``include_env_features``) is the offline
  encoder's own ``features``: the spectrogram is cut to the f0 grid before
  the frame-local envelopes are formed;
* under ``compute_dtype`` bf16 the front runs the offline bf16 pyramid, and
  each LSTM direction steps flax's ``OptimizedLSTMCell(dtype=bf16)``, as
  ``golf_tpu``'s stream does: gates in bf16, the carry c and the output h
  in fp32. The offline encoder computes its gates in fp32 (its fused
  LSTM), so the bf16 stream follows ``golf_tpu``'s stream, not the offline
  encoder.

Algorithmic latency: ``lookahead`` frames plus the front's reach,
n_conv_layers + ceil((n_fft / 2) / hop) frames (24 + 7 frames = 310 ms at
hop 240 and 24 kHz). The port's BiLSTM is one bidirectional ``nn.LSTM``;
here every layer and direction runs alone (in fp32 through ``torch.lstm``)
on the module's own parameter tensors, so a checkpoint loaded into the
encoder is what streams.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.sig import Sig
from ..models.enc import VocoderParameterEncoderInterface
from ..models.unet import UNetEncoder

Carry = Tuple[torch.Tensor, torch.Tensor]


class StreamingEncoder:
    """Stateful chunked encoder. ``push`` takes any number of samples (with
    the f0 at the sample rate) and returns the raw parameter rows (frame
    rate) that this push finalised, or None; ``flush`` drains the tail
    exactly. The encoder must be in eval mode."""

    def __init__(self, encoder: VocoderParameterEncoderInterface,
                 lookahead: int = 24, batch: int = 1):
        bb = encoder.backbone
        if not isinstance(bb, UNetEncoder):
            raise NotImplementedError(
                f"streaming needs the UNetEncoder backbone, got "
                f"{type(bb).__name__}")
        if not bb.f0_conditioning:
            raise ValueError("streaming needs an f0-conditioned encoder")
        if encoder.training:
            raise ValueError("the streaming encoder runs in eval mode: call "
                             ".eval() first")
        self.encoder = encoder
        self.bb = bb
        self.use_lru = bb.use_lru
        self.dtype = bb.dtype
        if self.use_lru:
            self.n_layers = bb.lru_block.num_layers
        else:
            self.lstm = bb.lstm.lstm
            self.n_layers = self.lstm.num_layers
            self.hidden = self.lstm.hidden_size
        self.device = bb.out_linear.weight.device
        self.hop = bb.hop_length
        self.n_fft = bb.n_fft
        self.nc = len(bb.pyramid.convs)
        # window frames contaminated by the window's own STFT padding
        self.stft_edge = -(-(self.n_fft // 2) // self.hop)
        self.edge = self.nc + self.stft_edge
        self.L = int(lookahead)

        self._x = torch.zeros((batch, 0), device=self.device)  # samples
        self._f0 = torch.zeros((batch, 0), device=self.device)
        self._base = 0              # absolute sample index of _x[:, 0]
        self._next_frame = 0        # next conv frame to produce
        self._pending: List[torch.Tensor] = []  # conv rows not yet emitted
        self._carries: List[Optional[Carry]] = [None] * self.n_layers
        # the LRU layers' complex states (None before the first emission)
        self._lru_states: List[Optional[torch.Tensor]] = [None] * self.n_layers
        self._done = False

    # ------------------------------------------------------------------
    def _conv_window(self, x_win: torch.Tensor, f0_win: torch.Tensor
                     ) -> torch.Tensor:
        """The offline front on a hop-aligned sample window: (B, S) ->
        (B, F_win, D). The f0 grid truncates the spectrogram before the
        pyramid, as offline: at the final window that puts the pyramid's
        right-edge zero padding at the offline frame count."""
        return self.bb.rows(*self.bb.features(Sig(x_win, 1), Sig(f0_win, 1),
                                              train=False))

    def _direction(self, layer: int, reverse: bool, h: torch.Tensor,
                   carry: Optional[Carry] = None
                   ) -> Tuple[torch.Tensor, Carry]:
        """One layer and direction of the BiLSTM over h (B, P, D) from
        ``carry`` (zero when None), with the module's own parameters.
        ``reverse`` runs from the right edge backwards and returns the
        outputs in time order. Returns (outputs, (h, c) after the last
        step run)."""
        if self.dtype is not None:
            return self._direction_cell(layer, reverse, h, carry)
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        weights = [getattr(self.lstm, f"{n}{sfx}")
                   for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        if carry is None:
            z = h.new_zeros((1, h.shape[0], self.hidden))
            carry = (z, z)
        if reverse:
            h = torch.flip(h, (1,))
        with warnings.catch_warnings():
            # cuDNN copies one layer's weights into its own buffer a call,
            # and warns that they are not one flattened chunk
            warnings.filterwarnings("ignore", message="RNN module weights")
            out, h_n, c_n = torch.lstm(h, carry, weights, True, 1, 0.0,
                                       False, False, True)
        if reverse:
            out = torch.flip(out, (1,))
        return out, (h_n, c_n)

    def _direction_cell(self, layer: int, reverse: bool, h: torch.Tensor,
                        carry: Optional[Carry] = None
                        ) -> Tuple[torch.Tensor, Carry]:
        """``_direction`` under a compute dtype, step by step as flax's
        ``OptimizedLSTMCell(dtype)``: both dense products and their bias
        rounded to the dtype, the gates in it, ``c = f c + i g`` and
        ``h = o tanh(c)`` promoted to fp32. The carry is ((B, H), (B, H))
        fp32."""
        dt = self.dtype
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        w_ih, w_hh, bias = (getattr(self.lstm, f"{n}{sfx}").to(dt)
                            for n in ("weight_ih", "weight_hh", "bias_hh"))
        xw = h.to(dt) @ w_ih.t()                     # (B, P, 4H)
        w_h = w_hh.t()
        if carry is None:
            z = h.new_zeros((h.shape[0], self.hidden), dtype=torch.float32)
            carry = (z, z)
        h_t, c = carry
        n = self.hidden
        outs = [None] * h.shape[1]
        for s in (range(h.shape[1] - 1, -1, -1) if reverse
                  else range(h.shape[1])):
            pre = (h_t.to(dt) @ w_h + bias) + xw[:, s]
            i, f, o = (torch.sigmoid(pre[:, k * n:(k + 1) * n])
                       for k in (0, 1, 3))
            g = torch.tanh(pre[:, 2 * n:3 * n])
            c = f.float() * c + (i * g).float()
            h_t = o.float() * torch.tanh(c)
            outs[s] = h_t
        return torch.stack(outs, dim=1), (h_t, c)

    def _bwd_window(self, layer: int, h: torch.Tensor) -> torch.Tensor:
        """The backward direction over a window from a zero carry at its
        right edge (the offline start at the utterance's end)."""
        return self._direction(layer, True, h)[0]

    # ------------------------------------------------------------------
    def _advance_front(self, final: bool) -> None:
        """Produce every conv row whose receptive field the samples so far
        cover (all rows, when ``final``)."""
        s_total = self._base + self._x.shape[1]
        if final:
            # the offline frame count: conv rows truncated to the f0 grid,
            # ceil(T / hop) rows (the centred spectrogram has T // hop + 1)
            n_frames = min(-(-s_total // self.hop), s_total // self.hop + 1)
            hi = n_frames - 1
        else:
            hi = (s_total - self.n_fft // 2) // self.hop - self.nc
        if hi < self._next_frame:
            return
        a = self._next_frame
        # hop-aligned, so window frame i is global frame s0 / hop + i
        s0 = max(0, (a - self.edge) * self.hop)
        rows = self._conv_window(self._x[:, s0 - self._base:],
                                 self._f0[:, s0 - self._base:])
        i0 = a - s0 // self.hop
        i1 = i0 + (hi - a + 1)
        if not final:
            # drop rows that see the window's own right-edge padding
            i1 = min(i1, rows.shape[1] - self.edge)
        if i1 <= i0:
            return
        self._pending.extend(rows[:, i0:i1].unbind(1))
        self._next_frame = a + (i1 - i0)
        # trim the rolling buffers to what the next window needs
        keep_from = max(0, (self._next_frame - self.edge) * self.hop)
        if keep_from > self._base:
            cut = keep_from - self._base
            self._x = self._x[:, cut:]
            self._f0 = self._f0[:, cut:]
            self._base = keep_from

    def _emit(self, n_keep: int) -> Optional[torch.Tensor]:
        """Run the BiLSTM over the pending rows, emit all but the newest
        ``n_keep``, and advance the forward carries over the emitted
        rows."""
        n_emit = len(self._pending) - n_keep
        if n_emit <= 0:
            return None
        h = torch.stack(self._pending, dim=1)          # (B, P, D)
        for i in range(self.n_layers):
            ys_f, carry = self._direction(i, False, h[:, :n_emit],
                                          self._carries[i])
            if n_keep > 0:
                ys_k, _ = self._direction(i, False, h[:, n_emit:], carry)
                ys_f = torch.cat([ys_f, ys_k], dim=1)
            self._carries[i] = carry
            h = torch.cat([ys_f, self._bwd_window(i, h)], dim=-1)
        self._pending = self._pending[n_emit:]
        return self.bb.head(h[:, :n_emit])

    def _emit_lru(self, final: bool) -> Optional[torch.Tensor]:
        """The LRU block over every pending row, from the carried states;
        the first emission waits for ``lookahead`` + 1 rows (or the flush)
        and predicts each layer's carry-in from its newest row."""
        if not self._pending:
            return None
        if self._lru_states[0] is None and not final and \
                len(self._pending) < self.L + 1:
            return None
        block = self.bb.lru_block
        h = block.dense0(torch.stack(self._pending, dim=1).to(
            block.dense0.weight.dtype))
        for i in range(self.n_layers):
            h, self._lru_states[i] = block.layer(i, h, self._lru_states[i])
        self._pending = []
        return self.bb.head(h)

    def _params(self, out: Optional[torch.Tensor]
                ) -> Optional[Dict[str, Any]]:
        return None if out is None else \
            self.encoder.params_from_head(Sig(out, self.hop))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def push(self, x, f0) -> Optional[Dict[str, Any]]:
        """Feed (B, S) samples and their sample-rate f0; returns the raw
        encoder rows this push finalised, or None."""
        if self._done:
            raise RuntimeError("push after flush")
        as_t = lambda v: torch.as_tensor(  # noqa: E731
            v, dtype=torch.float32, device=self.device)
        self._x = torch.cat([self._x, as_t(x)], dim=1)
        self._f0 = torch.cat([self._f0, as_t(f0)], dim=1)
        self._advance_front(final=False)
        return self._params(self._emit_lru(final=False) if self.use_lru
                            else self._emit(n_keep=self.L))

    @torch.no_grad()
    def flush(self) -> Optional[Dict[str, Any]]:
        """Drain: the true end reproduces the offline right padding and the
        backward directions' zero start, so these rows are exact."""
        if self._done:
            raise RuntimeError("flush after flush")
        self._done = True
        self._advance_front(final=True)
        return self._params(self._emit_lru(final=True) if self.use_lru
                            else self._emit(n_keep=0))


@torch.no_grad()
def backward_decay(encoder: VocoderParameterEncoderInterface,
                   h_rows: torch.Tensor,
                   lookaheads: Sequence[int] = (4, 8, 16, 24, 32, 48, 64)
                   ) -> Dict[int, float]:
    """The backward truncation's decay (layer 0): for each look-ahead L,
    the largest deviation, relative to the output's max-abs, of the first
    backward LSTM direction's output at a window's first row when run on an
    L-row window from a zero carry, against the full sequence; windows
    start at up to 16 evenly spaced rows."""
    se = StreamingEncoder(encoder, lookahead=0, batch=h_rows.shape[0])
    h_rows = h_rows.to(se.device)
    ref = se._bwd_window(0, h_rows)
    scale = ref.abs().max().item() + 1e-9
    t = h_rows.shape[1]
    out = {}
    for n in lookaheads:
        if n >= t:
            continue
        errs = [(se._bwd_window(0, h_rows[:, t0:t0 + n])[:, 0]
                 - ref[:, t0]).abs().max().item() / scale
                for t0 in range(0, t - n, max((t - n) // 16, 1))]
        out[n] = max(errs)
    return out
