"""All-pole (LPC synthesis) filters, forward (counterpart of
``golf_tpu.ops.allpole``).

    y[n] = x[n] - sum_{i=1..p} a_i[n] y[n-i],   zero initial state.

``allpole`` (time-varying, GOLF-ss) and ``allpole_const`` (constant per
row, GOLF-ff) route by device: a CUDA tensor goes to the hand-written
kernel (``kernels/csrc/allpole_tv.cu``, ``allpole_const.cu``), a CPU tensor
to the plain PyTorch version beside it (the sequential scan, or the blocked
two-pass form of ``golf_tpu``). Both are ``torch.autograd.Function``s with
``golf_tpu``'s adjoints, which run the same filter again on the reversed
cotangent, so the backward goes through the same kernel as the forward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..kernels import ALLPOLE_CONST, ALLPOLE_TV
from ._checks import check_kernel_inputs

MAX_ORDER = 64


def _choose_block(t: int) -> int:
    """A block length ~sqrt(T) rounded up to a multiple of 8."""
    l = int(math.sqrt(t))
    l = max(8, (l + 7) // 8 * 8)
    return min(l, t)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def allpole_scan(x: torch.Tensor, a: torch.Tensor,
                 zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential reference. x: (B, T), a: (B, T, p) -> (B, T)."""
    b, t = x.shape
    p = a.shape[-1]
    s = x.new_zeros((b, p)) if zi is None else zi
    ys = []
    for n in range(t):
        y_t = x[:, n] - torch.sum(a[:, n] * s, dim=-1)
        s = torch.cat([y_t[:, None], s[:, :-1]], dim=1)
        ys.append(y_t)
    return torch.stack(ys, dim=1) if ys else x.clone()


def _scan_affine(m: torch.Tensor, v: torch.Tensor):
    """Inclusive scan over dim 1 of the affine maps s -> m s + v, composed
    left to right (log-depth, Hillis-Steele)."""
    k = m.shape[1]
    shift = 1
    while shift < k:
        m_hi, v_hi = m[:, shift:], v[:, shift:]
        m_lo, v_lo = m[:, :-shift], v[:, :-shift]
        m = torch.cat([m[:, :shift], m_hi @ m_lo], dim=1)
        v = torch.cat([v[:, :shift],
                       (m_hi @ v_lo[..., None])[..., 0] + v_hi], dim=1)
        shift *= 2
    return m, v


def _allpole_blocked(x: torch.Tensor, a: torch.Tensor, zi: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Blocked two-pass form: pass A tracks, for every block in parallel,
    each output as an affine function of the block's incoming state; pass B
    composes the per-block maps (log depth) into every block's true
    incoming state, and y = y0 + H s_in."""
    bsz, t = x.shape
    p = a.shape[-1]
    l = min(block_size, t)
    k = (t + l - 1) // l
    pad = k * l - t
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(bsz, k, l)
    ap = torch.nn.functional.pad(a, (0, 0, 0, pad)).reshape(bsz, k, l, p)

    eye = torch.cat([torch.eye(p, dtype=x.dtype, device=x.device),
                     x.new_zeros((p, 1))], dim=1)
    w = eye.expand(bsz, k, p, p + 1)
    rs = []
    for n in range(l):
        r = -torch.einsum("bkp,bkpq->bkq", ap[:, :, n], w)
        r = torch.cat([r[..., :p], r[..., p:] + xp[:, :, n, None]], dim=-1)
        w = torch.cat([r[:, :, None, :], w[:, :, :-1, :]], dim=2)
        rs.append(r)
    rs = torch.stack(rs, dim=2)                # (B, K, L, p+1)
    h, y0 = rs[..., :p], rs[..., p]

    m_cum, v_cum = _scan_affine(w[..., :p], w[..., p])
    s_in = torch.cat([
        zi[:, None, :],
        (m_cum[:, :-1] @ zi[:, None, :, None])[..., 0] + v_cum[:, :-1],
    ], dim=1)                                  # (B, K, p)
    y = y0 + torch.einsum("bklp,bkp->bkl", h, s_in)
    return y.reshape(bsz, k * l)[:, :t]


def allpole_plain(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of the time-varying kernel: the scan for short
    signals, else the blocked two-pass form (``golf_tpu``'s dispatch)."""
    t = x.shape[1]
    zi = x.new_zeros((x.shape[0], a.shape[-1]))
    block = _choose_block(t)
    if t <= 64 or block >= t:
        return allpole_scan(x, a, zi)
    return _allpole_blocked(x, a, zi, block)


def _allpole_const_blocked(x: torch.Tensor, a: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """Blocked two-pass form with constant per-row coefficients: the state
    sensitivity H and block transition M are the same for every block of a
    row, so they are tracked once per row; only the zero-state response
    runs over (N, K)."""
    n, t = x.shape
    p = a.shape[-1]
    l = min(max(block_size, p), t)
    k = (t + l - 1) // l
    pad = k * l - t
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(n, k, l)

    s = x.new_zeros((n, k, p))
    y0 = []
    for j in range(l):
        y_t = xp[:, :, j] - torch.einsum("np,nkp->nk", a, s)
        s = torch.cat([y_t[..., None], s[..., :-1]], dim=-1)
        y0.append(y_t)
    y0 = torch.stack(y0, dim=2)                # (N, K, L)

    w = torch.eye(p, dtype=x.dtype, device=x.device).expand(n, p, p)
    hs = []
    for _ in range(l):
        r = -torch.einsum("np,npq->nq", a, w)
        w = torch.cat([r[:, None, :], w[:, :-1, :]], dim=1)
        hs.append(r)
    h = torch.stack(hs, dim=1)                 # (N, L, p)

    v_blk = y0[:, :, l - 1 - torch.arange(p, device=x.device)]  # (N, K, p)
    m_b = w[:, None].expand(n, k, p, p)
    _, v_cum = _scan_affine(m_b, v_blk)
    s_in = torch.cat([x.new_zeros((n, 1, p)), v_cum[:, :-1]], dim=1)
    y = y0 + torch.einsum("nlp,nkp->nkl", h, s_in)
    return y.reshape(n, k * l)[:, :t]


def allpole_const_plain(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of the constant-coefficient kernel (``golf_tpu``'s
    dispatch: blocked for T > max(64, p), else the scan)."""
    n, t = x.shape
    p = a.shape[-1]
    if t > max(64, p):
        return _allpole_const_blocked(x, a, _choose_block(t))
    return allpole_scan(x, a[:, None, :].expand(n, t, p))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def allpole_cuda(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Time-varying kernel. x: (B, T), a: (B, T, p), fp32, contiguous."""
    check_kernel_inputs("allpole", x=x, a=a)
    if x.ndim != 2:
        raise ValueError(f"allpole: x must be (B, T), got {tuple(x.shape)}")
    b, t = x.shape
    if a.ndim != 3 or a.shape[:2] != (b, t) or not 1 <= a.shape[2] <= MAX_ORDER:
        raise ValueError(f"allpole: a must be (B, T, 1..{MAX_ORDER}) for x "
                         f"{tuple(x.shape)}, got {tuple(a.shape)}")
    y = torch.empty_like(x)
    if x.numel():
        ALLPOLE_TV.launch(x.data_ptr(), a.data_ptr(), y.data_ptr(), b, t,
                          a.shape[2], x.device.index,
                          torch.cuda.current_stream(x.device).cuda_stream,
                          shapes=(tuple(x.shape), tuple(a.shape)))
    return y


def allpole_const_cuda(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Constant-coefficient kernel. x: (N, T), a: (N, p), fp32,
    contiguous."""
    check_kernel_inputs("allpole_const", x=x, a=a)
    if x.ndim != 2:
        raise ValueError(f"allpole_const: x must be (N, T), got "
                         f"{tuple(x.shape)}")
    n, t = x.shape
    if a.ndim != 2 or a.shape[0] != n or not 1 <= a.shape[1] <= MAX_ORDER:
        raise ValueError(f"allpole_const: a must be (N, 1..{MAX_ORDER}) for "
                         f"x {tuple(x.shape)}, got {tuple(a.shape)}")
    y = torch.empty_like(x)
    if x.numel():
        ALLPOLE_CONST.launch(x.data_ptr(), a.data_ptr(), y.data_ptr(), n, t,
                             a.shape[1], x.device.index,
                             torch.cuda.current_stream(x.device).cuda_stream,
                             shapes=(tuple(x.shape), tuple(a.shape)))
    return y


# ---------------------------------------------------------------------------
# Adjoints (golf_tpu/ops/allpole.py:214-259 and 385-408)
# ---------------------------------------------------------------------------

def _shift_columns(a: torch.Tensor) -> torch.Tensor:
    """c[:, n, j] = a[:, n + j + 1, j], zero past the end: coefficient j of
    the transposed recurrence at the time it multiplies dx."""
    t = a.shape[1]
    c = torch.zeros_like(a)
    for j in range(a.shape[-1]):
        c[:, :t - j - 1, j] = a[:, j + 1:, j]
    return c


def _delayed_stack(y: torch.Tensor, p: int) -> torch.Tensor:
    """d[:, n, j] = y[:, n - j - 1], zero before the start. (B, T) ->
    (B, T, p)."""
    t = y.shape[1]
    window = torch.nn.functional.pad(y, (p, 0))[:, :t + p - 1]
    return torch.flip(window.unfold(1, p, 1), (-1,))


def _reversed(fn: Callable, g: torch.Tensor, a: torch.Tensor
              ) -> torch.Tensor:
    """``flip(fn(flip(g), a))`` along time; ``a`` is passed as it is."""
    return torch.flip(fn(torch.flip(g, (1,)).contiguous(), a), (1,))


class _Allpole(torch.autograd.Function):
    """Time-varying all-pole with ``golf_tpu``'s adjoint: dx is the filter
    run backwards in time with the column-shifted coefficients, and
    ``da = -dx[..., None] * _delayed_stack(y, p)``."""

    @staticmethod
    def forward(ctx, x, a, fn):
        y = fn(x, a)
        ctx.save_for_backward(y, a)
        ctx.fn = fn
        return y

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        c = torch.flip(_shift_columns(a), (1,))
        dx = _reversed(ctx.fn, g, c)
        del c
        da = None
        if ctx.needs_input_grad[1]:
            da = -dx[..., None] * _delayed_stack(y, a.shape[-1])
        return dx, da, None


class _AllpoleConst(torch.autograd.Function):
    """Constant-coefficient all-pole with ``golf_tpu``'s adjoint: the
    transposed system has the same coefficients in reversed time, and da
    is p shifted dots (no (N, T, p) stack)."""

    @staticmethod
    def forward(ctx, x, a, fn):
        y = fn(x, a)
        ctx.save_for_backward(y, a)
        ctx.fn = fn
        return y

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        dx = _reversed(ctx.fn, g, a)
        da = None
        if ctx.needs_input_grad[1]:
            t = y.shape[1]
            da = -torch.stack([torch.sum(dx[:, j + 1:] * y[:, :t - j - 1],
                                         dim=1)
                               for j in range(a.shape[-1])], dim=-1)
        return dx, da, None


def allpole(x: torch.Tensor, a: torch.Tensor,
            fn: Optional[Callable] = None) -> torch.Tensor:
    """Time-varying all-pole, differentiable. x: (B, T), a: (B, T, p) ->
    (B, T). ``fn`` names the forward explicitly (``allpole_cuda`` or
    ``allpole_plain``, for comparisons on the card); by default the
    tensors' device decides."""
    if fn is None:
        fn = allpole_cuda if x.is_cuda else allpole_plain
    return _Allpole.apply(x, a, fn)


def allpole_const(x: torch.Tensor, a: torch.Tensor,
                  fn: Optional[Callable] = None) -> torch.Tensor:
    """Constant-coefficient all-pole, differentiable. x: (N, T), a: (N, p)
    -> (N, T). ``fn`` as for ``allpole``."""
    if fn is None:
        fn = allpole_const_cuda if x.is_cuda else allpole_const_plain
    return _AllpoleConst.apply(x, a, fn)
