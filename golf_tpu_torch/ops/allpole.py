"""All-pole (LPC synthesis) filters, forward (counterpart of
``golf_tpu.ops.allpole``).

    y[n] = x[n] - sum_{i=1..p} a_i[n] y[n-i],   zero initial state
    (``allpole_stream``: the state a previous chunk left).

``allpole`` (time-varying, GOLF-ss) and ``allpole_const`` (constant per
row, GOLF-ff) route by device: a CUDA tensor goes to the hand-written
kernels (``kernels/csrc/allpole_tv.cu``, ``allpole_const.cu``), a CPU
tensor to the plain PyTorch versions beside them (the sequential scan, or
the blocked two-pass form of ``golf_tpu``). Both are
``torch.autograd.Function``s with ``golf_tpu``'s adjoints: the transposed
filter on the reversed cotangent.

The time-varying kernel is chunked: float64 state maps of every chunk of
``chunk_for(B, T)`` steps, a float64 carry of the state across chunks, then
every chunk re-run from its incoming state. Its adjoint entry
(``allpole_adjoint_cuda``) reads the cotangent and the coefficients where
they lie, so the backward builds no column-shifted or flipped (B, T, p)
copy; on the CPU the adjoint stays ``golf_tpu``'s materialised form.
``allpole_chunked_plain`` is the kernel's algorithm in plain PyTorch (both
entries), for the tests and ``chip_smoke.py``; no route runs it.
``allpole_stream`` (streaming, no gradient) runs the forward entry from an
initial state ``zi``, the last p outputs of the previous chunk. The
time-sharded filter takes the summary entry (``allpole_summary_cuda``: a
row's float64 end-state map, composed as a tree from every chunk's map,
which it returns too) and then the re-run entry (``allpole_rerun_cuda``:
the carry and the re-run from those maps), so phase 1 runs once;
``allpole_summary_chunked_plain`` and ``allpole_rerun_plain`` are their
algorithms in plain PyTorch.

The constant-coefficient kernel is the sequential recurrence with a
float64 state, one row a thread. Its adjoint entry
(``allpole_const_adjoint_cuda``) walks the cotangent backwards in place and
forms ``da`` in the same pass; on the CPU the adjoint stays ``golf_tpu``'s
composite (flipped run, then p shifted dots). ``allpole_const_scan64`` and
``allpole_const_adjoint_scan64`` are the kernels' arithmetic in plain
PyTorch, for the tests and ``chip_smoke.py``; no route runs them.

``lpc_synthesis`` (frame-wise LPC) and ``lfilter`` (a constant IIR filter,
its FIR part a ``conv1d``) run their all-pole part on ``allpole_const``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.sig import linear_upsample
from ..kernels import (ALLPOLE_CONST, ALLPOLE_CONST_ADJ, ALLPOLE_TV,
                       ALLPOLE_TV_ADJ, ALLPOLE_TV_RERUN, ALLPOLE_TV_SUMMARY)
from ._checks import check_kernel_inputs
from .dsp import rc2lpc

MAX_ORDER = 64
# steps a chunk of the time-varying kernel (and of its plain mirror) at the
# training and serving shapes: of 256, 384 and 512, 512 ran fastest at both
# on the H100 (PERF.md)
CHUNK = 512
# the shorter chunks chunk_for may take, longest first
SHORT_CHUNKS = (256, 128, 64)
# CTAs of a one-warp phase that keep the H100's 132 SMs busy: a chunk's
# steps are a serial chain, so an SM needs several in flight
FILL_CTAS = 8 * 132
# the carry's serial chain a row, at most, where a shorter chunk would
# lengthen it: each map costs ~0.4 us on the H100, so at test_rtf's
# (1, 144 000) chunks of 256 or less run slower than 512 (PERF.md)
MAX_CARRY = 96


def chunk_for(b: int, t: int) -> int:
    """The time-varying kernel's chunk length for B rows of T steps:
    ``CHUNK`` where B ceil(T / CHUNK) one-warp CTAs fill the card, else the
    longest of ``SHORT_CHUNKS`` that does or, where none does, the
    shortest; never one whose ceil(T / L) chunks exceed ``MAX_CARRY``
    (``CHUNK`` stays then). A shorter chunk cuts each CTA's serial chain
    and lengthens the carry's, ceil(T / L) dependent p x p products
    (``tools/allpole_chunk_sweep.py`` measures the trade-off). The kernel's
    wrappers and ``allpole_chunked_plain`` take L from here."""
    best = CHUNK
    for chunk in (CHUNK,) + SHORT_CHUNKS:
        if chunk != CHUNK and -(-t // chunk) > MAX_CARRY:
            break
        best = chunk
        if b * -(-t // chunk) >= FILL_CTAS:
            break
    return best


# the only order whose phase 3 the kernel runs two chunks a warp (its
# register ring, kRingOrder in allpole_tv.cu)
PAIR_ORDER = 22


def rerun_chunks(b: int, t: int, p: int) -> int:
    """Chunks a CTA of the time-varying kernel's phase 3 (its entries take
    it as nc): 2 at ``PAIR_ORDER`` where the B ceil(T / L) chunks reach
    twice ``FILL_CTAS``, so that the paired grid still fills the card, else
    1. On the H100 pairs ran faster than one chunk a CTA at the training
    shape and a (64, 24 000) shard, and slower at a push (152 chunks leave
    SMs idle); four or eight chunks a CTA ran slower than two (PERF.md).
    Either way the outputs are the same bit for bit."""
    chunks = b * -(-t // chunk_for(b, t))
    return 2 if p == PAIR_ORDER and chunks >= 2 * FILL_CTAS else 1


# maps a CTA of the summary's tree composes, at most, and the tree's shared
# memory
TREE_MAPS = 16
TREE_SMEM = 200 * 1024


def tree_group(p: int) -> int:
    """NB, the maps a CTA of the summary's composition takes (its entry
    takes it as nb): the largest power of two up to ``TREE_MAPS`` whose NB
    maps and NB / 2 products, p (p + 1) doubles each, fit ``TREE_SMEM``;
    at least 2."""
    per = (p + 1) * p * 8
    nb = TREE_MAPS
    while nb > 2 and (nb + nb // 2) * per > TREE_SMEM:
        nb //= 2
    return nb


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


def _chunk_operands(x: torch.Tensor, a: torch.Tensor, chunk: int,
                    adjoint: bool):
    """The chunked kernel's view of (x, a): the float64 inputs (B, chunks,
    chunk) of every chunk's steps (zero past T) and ``coef(u)``, the
    (B, chunks, p) float64 taps of step u of every chunk (zero past T), read
    in place for the adjoint: reversed step m reads x[T - 1 - m] and, for
    tap j < m, a[T - m + j, j]. Also returns the steps (chunks, chunk)."""
    t = x.shape[1]
    p = a.shape[-1]
    n_chunks = -(-t // chunk)
    steps = torch.arange(n_chunks * chunk, device=x.device).view(n_chunks,
                                                                 chunk)
    taps = torch.arange(p, device=x.device)
    src = t - 1 - steps if adjoint else steps
    xs = torch.where(steps < t, x[:, src.clamp(0, t - 1)], 0).double()

    def coef(u: int) -> torch.Tensor:
        m = steps[:, u, None]
        rows = t - m + taps if adjoint else m.expand(n_chunks, p)
        ok = (rows < t) & (m < t)
        return torch.where(ok, a[:, rows.clamp(0, t - 1), taps], 0).double()

    return xs, coef, steps


def allpole_chunk_maps_plain(x: torch.Tensor, a: torch.Tensor,
                             chunk: Optional[int] = None,
                             adjoint: bool = False) -> torch.Tensor:
    """Phase 1 of the time-varying kernel: every chunk's float64 state map,
    (B, chunks, p + 1, p), [b, k, c, i] component i of the chunk's end state
    for a unit incoming component c (c = p: the zero-state response to the
    chunk's inputs); state component i is the output i + 1 steps back. The
    last chunk runs its steps below T only, as the kernel's does."""
    b, t = x.shape
    p = a.shape[-1]
    chunk = chunk_for(b, t) if chunk is None else chunk
    xs, coef, steps = _chunk_operands(x, a, chunk, adjoint)
    s = torch.cat([torch.eye(p, dtype=torch.float64, device=x.device),
                   x.new_zeros((1, p), dtype=torch.float64)])
    s = s.expand(b, steps.shape[0], p + 1, p)
    for u in range(chunk):
        r = -(s * coef(u)[:, :, None, :]).sum(-1)
        r[..., p] += xs[:, :, u]
        step = torch.cat([r[..., None], s[..., :-1]], dim=-1)
        s = torch.where((steps[:, u] < t)[None, :, None, None], step, s)
    return s


def allpole_rerun_plain(x: torch.Tensor, a: torch.Tensor,
                        zi: Optional[torch.Tensor], maps: torch.Tensor,
                        chunk: Optional[int] = None,
                        adjoint: bool = False) -> torch.Tensor:
    """Phases 2 and 3 of the time-varying kernel from the chunk maps (the
    first ceil(T / chunk) - 1 are read): the float64 carry of the state
    from ``zi`` (B, p) (zero when None), then every chunk re-run from its
    incoming state in float64. Returns y in x's dtype."""
    b, t = x.shape
    p = a.shape[-1]
    chunk = chunk_for(b, t) if chunk is None else chunk
    xs, coef, steps = _chunk_operands(x, a, chunk, adjoint)
    s_in = [x.new_zeros((b, p), dtype=torch.float64) if zi is None
            else zi.double()]
    for k in range(steps.shape[0] - 1):
        s_in.append(torch.einsum("bji,bj->bi", maps[:, k, :p], s_in[-1])
                    + maps[:, k, p])
    state = torch.stack(s_in, dim=1)
    ys = []
    for u in range(chunk):
        y_u = xs[:, :, u] - (state * coef(u)).sum(-1)
        state = torch.cat([y_u[..., None], state[..., :-1]], dim=-1)
        ys.append(y_u)
    y = torch.stack(ys, dim=2).reshape(b, -1)[:, :t].to(x.dtype)
    return torch.flip(y, (1,)) if adjoint else y


def allpole_chunked_plain(x: torch.Tensor, a: torch.Tensor,
                          chunk: Optional[int] = None,
                          adjoint: bool = False,
                          zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The time-varying kernel's algorithm, vectorised over chunks of
    ``chunk`` steps (``chunk_for`` by default; 2 chunk + ceil(T / chunk)
    Python steps): each chunk's state map and zero-state offset in float64
    (``allpole_chunk_maps_plain``), the float64 carry of the state across
    chunks from the initial state ``zi`` (B, p) in float64 (zero when
    None), then every chunk re-run from its incoming state, also in float64
    (``allpole_rerun_plain``). With ``adjoint`` it returns the transposed
    filter of the cotangent ``x``,
    ``flip(allpole(flip(x), flip(_shift_columns(a))))``, indexing ``x`` and
    ``a`` in place as the adjoint entry does."""
    maps = allpole_chunk_maps_plain(x, a, chunk, adjoint)
    return allpole_rerun_plain(x, a, zi, maps, chunk, adjoint)


def _compose_maps(later: torch.Tensor, earlier: torch.Tensor
                  ) -> torch.Tensor:
    """later o earlier for maps stored by column (..., p + 1, p): column
    c < p is later's M times earlier's column c, column p adds later's
    offset (the kernel's ``compose_entry``)."""
    p = later.shape[-1]
    out = torch.einsum("...cj,...ji->...ci", earlier, later[..., :p, :])
    return torch.cat([out[..., :p, :], out[..., p:, :] + later[..., p:, :]],
                     dim=-2)


def _tree(maps: torch.Tensor) -> torch.Tensor:
    """(..., n, p + 1, p) maps in time order composed as the kernel's tree:
    each level multiplies neighbours (2j + 1 after 2j) and passes an odd
    last map on. Returns (..., p + 1, p)."""
    while maps.shape[-3] > 1:
        n = maps.shape[-3]
        pairs = _compose_maps(maps[..., 1:n - n % 2:2, :, :],
                              maps[..., 0:n - n % 2:2, :, :])
        maps = torch.cat([pairs, maps[..., n - n % 2:, :, :]], dim=-3)
    return maps[..., 0, :, :]


def compose_tree_plain(maps: torch.Tensor) -> torch.Tensor:
    """The summary entry's composition of a row's chunk maps (B, K, p + 1,
    p), in the kernel's order: groups of NB (``tree_group``) maps each
    composed as a tree, then the group products, NB at a time, the product
    so far first in each round after the first. Returns the row's map
    (B, p + 1, p)."""
    b, k, _, p = maps.shape
    nb = tree_group(p)
    parts = [_tree(maps[:, g:g + nb]) for g in range(0, k, nb)]
    if len(parts) == 1:
        return parts[0]
    w, g0 = None, 0
    while g0 < len(parts):
        lead = [] if w is None else [w]
        take = parts[g0:g0 + nb - len(lead)]
        w = _tree(torch.stack(lead + take, dim=1))
        g0 += len(take)
    return w


def allpole_summary_chunked_plain(x: torch.Tensor, a: torch.Tensor,
                                  chunk: Optional[int] = None):
    """The summary entry's algorithm in plain PyTorch, float64: every
    chunk's map (``allpole_chunk_maps_plain``, the last chunk included),
    composed as the kernel's tree (``compose_tree_plain``). Returns (M
    (B, p, p), v (B, p), the maps (B, chunks, p + 1, p)), s_out = M s_in +
    v."""
    maps = allpole_chunk_maps_plain(x, a, chunk)
    w = compose_tree_plain(maps)
    p = a.shape[-1]
    return w[:, :p].transpose(1, 2), w[:, p], maps


def resonant_inputs(seed: int, b: int = 4, t: int = 4800, p: int = 22,
                    cap: Optional[float] = 0.95):
    """Inputs of the resonance checks (tests, ``chip_smoke.py``): x (B, T)
    ~ N(0, 1) and coefficients as GOLF-ss's filter makes them near the unit
    circle, rc2lpc(cap tanh(logits)) (rc2lpc(tanh(logits)) without a cap),
    the logits N(0, 1) per sequence plus a slow random walk (steps of
    0.1 N(0, 1)) over 240-sample frames, upsampled linearly. fp32 CPU
    tensors, from numpy's generator at ``seed``."""
    rng = np.random.default_rng(seed)
    frames = -(-t // 240) + 1
    logits = (rng.standard_normal((b, 1, p))
              + np.cumsum(0.1 * rng.standard_normal((b, frames, p)), axis=1))
    rc = torch.tanh(torch.from_numpy(logits.astype(np.float32)))
    a = rc2lpc(rc if cap is None else cap * rc)
    a = linear_upsample(a, 240, axis=1)[:, :t].contiguous()
    x = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32))
    return x, a


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


def allpole_const_scan64(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The constant-coefficient kernel's arithmetic: the sequential
    recurrence with a float64 state and sums. x: (N, T), a: (N, p) -> (N, T)
    in x's dtype."""
    n, t = x.shape
    c = a.double()
    s = x.new_zeros((n, a.shape[1]), dtype=torch.float64)
    ys = []
    for u in range(t):
        y_u = x[:, u].double() - (c * s).sum(-1)
        s = torch.cat([y_u[:, None], s[:, :-1]], dim=1)
        ys.append(y_u)
    return torch.stack(ys, dim=1).to(x.dtype) if ys else x.clone()


def allpole_const_adjoint_scan64(g: torch.Tensor, y: torch.Tensor,
                                 a: torch.Tensor):
    """The adjoint entry's arithmetic: the transposed recurrence walked from
    the end with a float64 state, dx[t] = g[t] - sum_i a[i] dx[t + 1 + i],
    and da[j] = -sum_s y[s] dx[s + 1 + j], each y[s] paired with the
    float64 state before step s (which holds dx[s + 1..s + p]), as the
    kernel pairs them. Returns (dx, da) in g's dtype."""
    n, t = g.shape
    c = a.double()
    s = g.new_zeros((n, a.shape[1]), dtype=torch.float64)
    da = torch.zeros_like(s)
    yd = y.double()
    dxs = []
    for u in range(t - 1, -1, -1):
        da += yd[:, u, None] * s
        d = g[:, u].double() - (c * s).sum(-1)
        s = torch.cat([d[:, None], s[:, :-1]], dim=1)
        dxs.append(d)
    dx = torch.stack(dxs[::-1], dim=1).to(g.dtype) if dxs else g.clone()
    return dx, (-da).to(g.dtype)


def resonant_const_inputs(seed: int, n: int = 256, t: int = 960,
                          p: int = 22, cap: Optional[float] = 0.95):
    """Inputs of the constant-coefficient resonance checks (tests,
    ``chip_smoke.py``): x (N, T) ~ N(0, 1) and per-row coefficients
    rc2lpc(cap tanh(z)) (rc2lpc(tanh(z)) without a cap), z ~ N(0, 1) i.i.d.
    per row and tap. fp32 CPU tensors, from numpy's generator at
    ``seed``."""
    rng = np.random.default_rng(seed)
    rc = torch.tanh(torch.from_numpy(
        rng.standard_normal((n, p)).astype(np.float32)))
    a = rc2lpc(rc if cap is None else cap * rc).contiguous()
    x = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    return x, a


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_tv(name: str, x: torch.Tensor, a: torch.Tensor,
              zi: Optional[torch.Tensor] = None) -> int:
    """Check the time-varying kernel's operands; returns p."""
    check_kernel_inputs(name, x=x, a=a,
                        **({} if zi is None else {"zi": zi}))
    if x.ndim != 2 or not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"{name}: x must be (B, T) with B <= 65535, got "
                         f"{tuple(x.shape)}")
    b, t = x.shape
    if a.ndim != 3 or a.shape[:2] != (b, t) or not 1 <= a.shape[2] <= MAX_ORDER:
        raise ValueError(f"{name}: a must be (B, T, 1..{MAX_ORDER}) for x "
                         f"{tuple(x.shape)}, got {tuple(a.shape)}")
    p = a.shape[2]
    if zi is not None and tuple(zi.shape) != (b, p):
        raise ValueError(f"{name}: zi must be (B, p) = {(b, p)}, got "
                         f"{tuple(zi.shape)}")
    return p


def _stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _allpole_tv_launch(kernel, name: str, x: torch.Tensor, a: torch.Tensor,
                       zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward or adjoint entry of the time-varying kernel with
    the (nullable) initial state zi, at ``chunk_for``'s chunk length."""
    p = _check_tv(name, x, a, zi)
    b, t = x.shape
    y = torch.empty_like(x)
    if x.numel():
        chunk = chunk_for(b, t)
        n_chunks = -(-t // chunk)
        # float64 maps (B, chunks, p + 1, p), then incoming states
        scratch = torch.empty(b * n_chunks * ((p + 1) * p + p),
                              dtype=torch.float64, device=x.device)
        kernel.launch(x.data_ptr(), a.data_ptr(),
                      None if zi is None else zi.data_ptr(), y.data_ptr(),
                      scratch.data_ptr(), b, t, p, chunk,
                      rerun_chunks(b, t, p), x.device.index, _stream_of(x),
                      shapes=(tuple(x.shape), tuple(a.shape)))
    return y


def allpole_cuda(x: torch.Tensor, a: torch.Tensor,
                 zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Time-varying kernel. x: (B, T), a: (B, T, p), fp32, contiguous; zi
    (B, p), the last p outputs before x, most recent first (None: a zero
    state)."""
    return _allpole_tv_launch(ALLPOLE_TV, "allpole", x, a, zi)


def allpole_adjoint_cuda(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The time-varying kernel's adjoint entry: dx of the cotangent g (B, T)
    for coefficients a (B, T, p), read in place."""
    return _allpole_tv_launch(ALLPOLE_TV_ADJ, "allpole_adjoint", g, a)


def allpole_summary_cuda(x: torch.Tensor, a: torch.Tensor):
    """The time-varying kernel's summary entry: the affine end-state map of
    each row, ``s_out = M s_in + v`` (state component i the output i + 1
    steps back), as float64 M (B, p, p) and v (B, p), and every chunk's
    float64 map (B, chunks, p + 1, p) at ``chunk_for``'s length, which
    ``allpole_rerun_cuda`` takes. x: (B, T), a: (B, T, p), fp32,
    contiguous."""
    p = _check_tv("allpole_summary", x, a)
    b, t = x.shape
    if t < 1:
        raise ValueError("allpole_summary: T must be at least 1")
    n_chunks = -(-t // chunk_for(b, t))
    nb = tree_group(p)
    m = torch.empty((b, p, p), dtype=torch.float64, device=x.device)
    v = torch.empty((b, p), dtype=torch.float64, device=x.device)
    maps = torch.empty((b, n_chunks, p + 1, p), dtype=torch.float64,
                       device=x.device)
    # the tree's group products (NB maps a group), then b counters
    scratch = torch.empty(b * -(-n_chunks // nb) * (p + 1) * p + -(-b // 2),
                          dtype=torch.float64, device=x.device)
    ALLPOLE_TV_SUMMARY.launch(
        x.data_ptr(), a.data_ptr(), m.data_ptr(), v.data_ptr(),
        maps.data_ptr(), scratch.data_ptr(), b, t, p, chunk_for(b, t), nb,
        x.device.index, _stream_of(x),
        shapes=(tuple(x.shape), tuple(a.shape)))
    return m, v, maps


def allpole_rerun_cuda(x: torch.Tensor, a: torch.Tensor, zi: torch.Tensor,
                       maps: torch.Tensor) -> torch.Tensor:
    """The forward entry from ``allpole_summary_cuda``'s maps of the same
    (x, a): the float64 carry from zi (B, p) and the re-run of every chunk
    (no phase 1). Equals ``allpole_cuda(x, a, zi)`` bit for bit."""
    p = _check_tv("allpole_rerun", x, a, zi)
    b, t = x.shape
    n_chunks = -(-t // chunk_for(b, t))
    if maps.dtype != torch.float64 or maps.device != x.device or \
            tuple(maps.shape) != (b, n_chunks, p + 1, p) or \
            not maps.is_contiguous():
        raise ValueError(f"allpole_rerun: maps must be the summary's "
                         f"contiguous float64 {(b, n_chunks, p + 1, p)} on "
                         f"{x.device}, got {maps.dtype} {tuple(maps.shape)} "
                         f"on {maps.device}")
    y = torch.empty_like(x)
    s_in = torch.empty(b * n_chunks * p, dtype=torch.float64,
                       device=x.device)
    ALLPOLE_TV_RERUN.launch(
        x.data_ptr(), a.data_ptr(), zi.data_ptr(), maps.data_ptr(),
        y.data_ptr(), s_in.data_ptr(), b, t, p, chunk_for(b, t),
        rerun_chunks(b, t, p), x.device.index, _stream_of(x),
        shapes=(tuple(x.shape), tuple(a.shape)))
    return y


def _divisor_block(t: int) -> int:
    """The divisor of t in [8, 1024] closest to sqrt(t), or t when there is
    none (``golf_tpu``'s ``seqpar._divisor_block``): the summary must not
    zero-pad to a block multiple, since a padded step shifts zeros into
    the tracked state and corrupts the end-state map."""
    target = max(8, int(math.sqrt(t)))
    best = None
    for l in range(8, min(t, 1024) + 1):
        if t % l == 0 and (best is None
                           or abs(l - target) < abs(best - target)):
            best = l
    return best or t


def allpole_summary_plain(x: torch.Tensor, a: torch.Tensor):
    """Plain version of the summary entry, ``golf_tpu``'s
    ``_local_affine_summary`` in x's dtype: every block of
    ``_divisor_block(T)`` steps tracks its map (the state's response to each
    incoming component and the zero-state response), then the block maps
    compose. Returns (M (B, p, p), v (B, p))."""
    bsz, t = x.shape
    p = a.shape[-1]
    l = _divisor_block(t)
    k = t // l
    xp = x.reshape(bsz, k, l)
    ap = a.reshape(bsz, k, l, p)
    w = torch.cat([torch.eye(p, dtype=x.dtype, device=x.device),
                   x.new_zeros((p, 1))], dim=1).expand(bsz, k, p, p + 1)
    for n in range(l):
        r = -torch.einsum("bkp,bkpq->bkq", ap[:, :, n], w)
        r = torch.cat([r[..., :p], r[..., p:] + xp[:, :, n, None]], dim=-1)
        w = torch.cat([r[:, :, None, :], w[:, :, :-1, :]], dim=2)
    m_cum, v_cum = _scan_affine(w[..., :p], w[..., p])
    return m_cum[:, -1], v_cum[:, -1]


def _check_const_shapes(name: str, x: torch.Tensor, a: torch.Tensor
                        ) -> None:
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be (N, T), got {tuple(x.shape)}")
    if a.ndim != 2 or a.shape[0] != x.shape[0] or \
            not 1 <= a.shape[1] <= MAX_ORDER:
        raise ValueError(f"{name}: a must be (N, 1..{MAX_ORDER}) for x "
                         f"{tuple(x.shape)}, got {tuple(a.shape)}")


def allpole_const_cuda(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Constant-coefficient kernel. x: (N, T), a: (N, p), fp32,
    contiguous."""
    check_kernel_inputs("allpole_const", x=x, a=a)
    _check_const_shapes("allpole_const", x, a)
    n, t = x.shape
    y = torch.empty_like(x)
    if x.numel():
        ALLPOLE_CONST.launch(x.data_ptr(), a.data_ptr(), y.data_ptr(), n, t,
                             a.shape[1], x.device.index,
                             torch.cuda.current_stream(x.device).cuda_stream,
                             shapes=(tuple(x.shape), tuple(a.shape)))
    return y


def allpole_const_adjoint_cuda(g: torch.Tensor, y: torch.Tensor,
                               a: torch.Tensor, with_da: bool = True):
    """The constant-coefficient kernel's adjoint entry: (dx, da) for the
    cotangent g (N, T) of y = allpole_const(x, a), g and y read in place;
    da (N, p) is None without ``with_da`` (then y is not read)."""
    check_kernel_inputs("allpole_const_adjoint", g=g, y=y, a=a)
    _check_const_shapes("allpole_const_adjoint", g, a)
    if y.shape != g.shape:
        raise ValueError(f"allpole_const_adjoint: y {tuple(y.shape)} must "
                         f"have g's shape {tuple(g.shape)}")
    n, t = g.shape
    dx = torch.empty_like(g)
    da = torch.empty_like(a) if with_da else None
    if g.numel():
        ALLPOLE_CONST_ADJ.launch(
            g.data_ptr(), y.data_ptr(), a.data_ptr(), dx.data_ptr(),
            da.data_ptr() if with_da else None, n, t, a.shape[1],
            g.device.index, torch.cuda.current_stream(g.device).cuda_stream,
            shapes=(tuple(g.shape), tuple(a.shape)))
    elif with_da:
        da.zero_()
    return dx, da


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


def allpole_adjoint_plain(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``golf_tpu``'s adjoint of the time-varying filter: the plain forward
    on the flipped cotangent and the flipped, column-shifted
    coefficients."""
    return _reversed(allpole_plain, g, torch.flip(_shift_columns(a), (1,)))


class AllpoleOps(NamedTuple):
    """The two functions of one route of the time-varying filter: forward
    (x, a) -> y and adjoint (g, a) -> dx."""
    fwd: Callable
    adj: Callable


CUDA_OPS = AllpoleOps(allpole_cuda, allpole_adjoint_cuda)
PLAIN_OPS = AllpoleOps(allpole_plain, allpole_adjoint_plain)


def _const_adjoint_composite(fwd: Callable, g: torch.Tensor, y: torch.Tensor,
                             a: torch.Tensor, with_da: bool = True):
    """``golf_tpu``'s adjoint of the constant-coefficient filter around the
    forward ``fwd``: dx is ``fwd`` on the flipped cotangent, flipped back,
    and da is p shifted dots. ``golf_tpu`` slices y[:, :t - j - 1], which
    wraps for j >= t and raises for T < p; here the slice stops at 0, so
    those taps get 0."""
    dx = _reversed(fwd, g, a)
    da = None
    if with_da:
        t = y.shape[1]
        da = -torch.stack([torch.sum(dx[:, j + 1:] * y[:, :max(t - j - 1, 0)],
                                     dim=1)
                           for j in range(a.shape[-1])], dim=-1)
    return dx, da


def allpole_const_adjoint_plain(g: torch.Tensor, y: torch.Tensor,
                                a: torch.Tensor, with_da: bool = True):
    """``golf_tpu``'s adjoint of the constant-coefficient filter on the
    plain forward: (dx, da), da None without ``with_da``."""
    return _const_adjoint_composite(allpole_const_plain, g, y, a, with_da)


class ConstOps(NamedTuple):
    """The two functions of one route of the constant-coefficient filter:
    forward (x, a) -> y and adjoint (g, y, a, with_da) -> (dx, da)."""
    fwd: Callable
    adj: Callable


CONST_CUDA_OPS = ConstOps(allpole_const_cuda, allpole_const_adjoint_cuda)
CONST_PLAIN_OPS = ConstOps(allpole_const_plain, allpole_const_adjoint_plain)


class _Allpole(torch.autograd.Function):
    """Time-varying all-pole with ``golf_tpu``'s adjoint: dx is the filter
    run backwards in time with the column-shifted coefficients, and
    ``da = -dx[..., None] * _delayed_stack(y, p)``."""

    @staticmethod
    def forward(ctx, x, a, ops):
        y = ops.fwd(x, a)
        ctx.save_for_backward(y, a)
        ctx.ops = ops
        return y

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        dx = ctx.ops.adj(g.contiguous(), a)
        da = None
        if ctx.needs_input_grad[1]:
            da = -dx[..., None] * _delayed_stack(y, a.shape[-1])
        return dx, da, None


class _AllpoleConst(torch.autograd.Function):
    """Constant-coefficient all-pole with ``golf_tpu``'s adjoint: the
    transposed system has the same coefficients in reversed time, and
    ``da[j] = -sum_t dx[t] y[t - j - 1]`` (no (N, T, p) stack); the route's
    adjoint forms both (on CUDA in one pass, da only when ``a`` needs a
    gradient)."""

    @staticmethod
    def forward(ctx, x, a, ops):
        y = ops.fwd(x, a)
        ctx.save_for_backward(y, a)
        ctx.ops = ops
        return y

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        dx, da = ctx.ops.adj(g.contiguous(), y, a, ctx.needs_input_grad[1])
        return dx, da, None


def allpole(x: torch.Tensor, a: torch.Tensor,
            ops: Optional[AllpoleOps] = None) -> torch.Tensor:
    """Time-varying all-pole, differentiable. x: (B, T), a: (B, T, p) ->
    (B, T). ``ops`` names the route explicitly (``CUDA_OPS`` or
    ``PLAIN_OPS``, for comparisons on the card); by default the tensors'
    device decides."""
    if ops is None:
        ops = CUDA_OPS if x.is_cuda else PLAIN_OPS
    return _Allpole.apply(x, a, ops)


def allpole_const(x: torch.Tensor, a: torch.Tensor,
                  ops: Optional[ConstOps] = None) -> torch.Tensor:
    """Constant-coefficient all-pole, differentiable. x: (N, T), a: (N, p)
    -> (N, T). ``ops`` names the route explicitly (``CONST_CUDA_OPS`` or
    ``CONST_PLAIN_OPS``, for comparisons on the card); by default the
    tensors' device decides."""
    if ops is None:
        ops = CONST_CUDA_OPS if x.is_cuda else CONST_PLAIN_OPS
    return _AllpoleConst.apply(x, a, ops)


def allpole_stream(x: torch.Tensor, a: torch.Tensor,
                   zi: Optional[torch.Tensor] = None):
    """Stateful time-varying all-pole for streaming (``golf_tpu``'s
    ``allpole_stream``). x: (B, Tc), a: (B, Tc, p), zi: (B, p), the last p
    outputs of the previous chunk, most recent first (zero at stream start,
    or None). Returns ``(y, zi_next)`` in float32, so that consecutive
    chunks reproduce the one-shot filter on the concatenation. Inference
    only: no gradient. A CUDA tensor goes to the kernel's forward entry with
    ``zi``; a CPU tensor to ``golf_tpu``'s form with the state (the scan
    for short chunks, else the blocked two-pass form)."""
    p = a.shape[-1]
    if x.shape[1] < p:
        raise ValueError(f"allpole_stream: a chunk of {x.shape[1]} samples "
                         f"is shorter than the order {p}")
    with torch.no_grad():
        x32, a32 = x.float().contiguous(), a.float().contiguous()
        zi32 = x32.new_zeros((x.shape[0], p)) if zi is None \
            else zi.float().contiguous()
        y = (allpole_cuda if x.is_cuda else allpole_stream_plain)(x32, a32,
                                                                  zi32)
    return y.to(x.dtype), torch.flip(y[:, -p:], (1,))


def allpole_stream_plain(x: torch.Tensor, a: torch.Tensor,
                         zi: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's initial-state entry, ``golf_tpu``'s
    streaming form: the scan from ``zi`` for short chunks, else the blocked
    two-pass form from ``zi``."""
    t = x.shape[1]
    block = _choose_block(t)
    if t <= 64 or block >= t:
        return allpole_scan(x, a, zi)
    return _allpole_blocked(x, a, zi, block)


def lpc_synthesis(source: torch.Tensor, gains: torch.Tensor,
                  a: torch.Tensor) -> torch.Tensor:
    """Frame-wise LPC synthesis, lfilter(x, [1, a...], [gain, 0...]):
    source (N, T), gains (N,), a (N, p) -> (N, T), by ``allpole_const``
    (B2 on the card)."""
    return allpole_const((source * gains[:, None]).contiguous(),
                         a.contiguous())


def lfilter(x: torch.Tensor, a_coeffs: torch.Tensor,
            b_coeffs: torch.Tensor) -> torch.Tensor:
    """A constant IIR filter as torchaudio's ``lfilter`` (coefficients
    shared by the rows, normalised by a0, no clamp): x (B, T), a_coeffs and
    b_coeffs (K,). The FIR part is a ``conv1d``; the all-pole part is
    ``allpole_const`` (B2 on the card) with a broadcast to (B, p)."""
    a0 = a_coeffs[0]
    b = b_coeffs / a0
    a = a_coeffs[1:] / a0
    k = b.shape[0]
    xp = torch.nn.functional.pad(x, (k - 1, 0))[:, None, :]
    fir_out = torch.nn.functional.conv1d(
        xp, torch.flip(b, (0,)).to(x.dtype)[None, None, :])[:, 0, :]
    a_b = a.to(x.dtype).expand(x.shape[0], a.shape[0]).contiguous()
    return allpole_const(fir_out.contiguous(), a_b)
