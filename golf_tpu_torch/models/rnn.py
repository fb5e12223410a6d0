"""Recurrent layers (counterpart of ``golf_tpu.models.rnn``): ``BiLSTM``,
the encoders' backbone, and the one-way ``LSTM``.

A bidirectional ``nn.LSTM`` (cuDNN on the GPU). The gate order (i, f, g, o)
and activations are those of flax's ``OptimizedLSTMCell``; the bridge
(``golf_tpu_torch.bridge``) maps its per-gate kernels onto this layout.
flax's cell has one bias, on the h side: ``bias_ih_*`` stays zero and does
not train (``requires_grad`` is off, so an optimizer and a gradient clip
over the trainable parameters do not see it).

With ``dtype=torch.bfloat16`` the same parameters run ``golf_tpu``'s bf16
recurrence (``_fused_lstm``, golf_tpu/models/rnn.py:41-119, :160-172)
instead of ``nn.LSTM``: the input projection hoisted out of the loop and
rounded to bf16, the recurrent matmul on h cast to bf16, the gate
arithmetic, the carry c and the output h in fp32, and a hand-written BPTT
whose weight and bias gradients are hoisted out of the reverse loop. Both
directions of a layer run as one batched step. The same code runs on both
devices: cuDNN's bf16 LSTM keeps its carry in another precision.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class _FusedLSTM(torch.autograd.Function):
    """The bf16 recurrence of ``D`` independent directions over T steps,
    in step order: xw (T, D, B, 4H) bf16, the hoisted input projection;
    w_h (D, H, 4H) bf16; b (D, 4H) fp32. Returns the outputs h (T, D, B, H)
    in fp32. The backward is ``_fused_lstm_bwd``'s: dgates in fp32, cast to
    bf16 for the recurrent matmul and for the hoisted dW_h and dxw."""

    @staticmethod
    def forward(ctx, xw, w_h, b):
        t, d, bsz, four_h = xw.shape
        h_feat = four_h // 4
        c = xw.new_zeros((d, bsz, h_feat), dtype=torch.float32)
        h = torch.zeros_like(c)
        bias = b[:, None, :]
        hs, cs, acts, gs = [], [], [], []
        for step in range(t):
            pre = torch.bmm(h.to(torch.bfloat16), w_h).float() + bias \
                + xw[step].float()
            act = torch.sigmoid(pre)
            g = torch.tanh(pre[..., 2 * h_feat:3 * h_feat])
            i, f, o = (act[..., :h_feat], act[..., h_feat:2 * h_feat],
                       act[..., 3 * h_feat:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            acts.append(act)
            gs.append(g)
        ys = torch.stack(hs)                           # (T, D, B, H)
        ctx.save_for_backward(ys, torch.stack(cs), torch.stack(acts),
                              torch.stack(gs), w_h)
        return ys

    @staticmethod
    def backward(ctx, dys):
        ys, cs, acts, g, w_h = ctx.saved_tensors
        t = ys.shape[0]
        h_feat = ys.shape[-1]
        # sigmoid of the g slot is unused: that gate is tanh (saved as g)
        i, f, _, o = acts.split(h_feat, dim=-1)
        c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
        th = torch.tanh(cs)
        # the step's factors that need no carry, for every step at once
        dc_dh = o * (1.0 - th * th)
        dg_dc = torch.cat([g * i * (1 - i), c_prev * f * (1 - f),
                           i * (1 - g * g)], dim=-1)
        do_dh = th * o * (1 - o)
        w_h_t = w_h.transpose(1, 2)
        dc_next = torch.zeros_like(ys[0])
        dh_next = torch.zeros_like(ys[0])
        dgates = [None] * t
        for step in range(t - 1, -1, -1):
            dh = dys[step] + dh_next
            dc = dh * dc_dh[step] + dc_next
            dgates[step] = torch.cat(
                [dc.repeat(1, 1, 3) * dg_dc[step], dh * do_dh[step]], dim=-1)
            dh_next = torch.bmm(dgates[step].to(torch.bfloat16),
                                w_h_t).float()
            dc_next = dc * f[step]
        dgates = torch.stack(dgates)                   # (T, D, B, 4H)
        ga = dgates.to(torch.bfloat16)
        dw_h = torch.einsum("tdbh,tdbg->dhg", h_prev.to(torch.bfloat16), ga)
        db = dgates.sum(dim=(0, 2))
        return ga, dw_h, db


def fused_bilstm_layer(x: torch.Tensor, w_ih: torch.Tensor,
                       w_hh: torch.Tensor, b_hh: torch.Tensor
                       ) -> torch.Tensor:
    """One bidirectional layer of ``golf_tpu``'s bf16 LSTM over x (B, T, C)
    -> (B, T, 2H) fp32. w_ih (2, 4H, C), w_hh (2, 4H, H) and b_hh (2, 4H):
    ``nn.LSTM``'s forward and reverse parameters, stacked."""
    xb = x.to(torch.bfloat16)
    xw = torch.einsum("btc,dgc->tdbg", xb, w_ih.to(torch.bfloat16))
    # the reverse direction runs forward in step order over flipped time
    xw = torch.stack([xw[:, 0], torch.flip(xw[:, 1], (0,))], dim=1)
    ys = _FusedLSTM.apply(xw, w_hh.transpose(1, 2).to(torch.bfloat16), b_hh)
    fwd, bwd = ys[:, 0], torch.flip(ys[:, 1], (0,))
    return torch.cat([fwd, bwd], dim=-1).transpose(0, 1)


class BiLSTM(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers,
                            batch_first=True, bidirectional=True,
                            dropout=dropout if num_layers > 1 else 0.0)
        self.dtype = dtype
        for name, prm in self.lstm.named_parameters():
            if name.startswith("bias_ih"):
                nn.init.zeros_(prm)
                prm.requires_grad_(False)

    def layer_weights(self, layer: int):
        """Layer ``layer``'s (w_ih, w_hh, b_hh), forward and reverse
        stacked."""
        return tuple(torch.stack([getattr(self.lstm, f"{n}_l{layer}{s}")
                                  for s in ("", "_reverse")])
                     for n in ("weight_ih", "weight_hh", "bias_hh"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return self.lstm(x)[0]
        h = x
        for layer in range(self.lstm.num_layers):
            h = fused_bilstm_layer(h, *self.layer_weights(layer))
            if layer < self.lstm.num_layers - 1:
                h = F.dropout(h, self.lstm.dropout, self.training)
        return h


class LSTM(nn.Module):
    """The one-way LSTM (counterpart of ``golf_tpu.models.rnn.LSTM``): a
    unidirectional ``nn.LSTM`` (cuDNN fp32 on the GPU) with flax's gates
    and its one bias, on the h side (``bias_ih_*`` stays zero and does not
    train); ``dropout`` between layers in train mode."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers,
                            batch_first=True,
                            dropout=dropout if num_layers > 1 else 0.0)
        for name, prm in self.lstm.named_parameters():
            if name.startswith("bias_ih"):
                nn.init.zeros_(prm)
                prm.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lstm(x)[0]
