"""Sequence (time-axis) parallelism of the synthesis chains (counterpart of
``golf_tpu.parallel.seqpar``).

The sample-rate decoder and the MSS loss run on a time window of the batch
on each rank of a time group, the frame-rate encoder on every rank over its
data shard's rows, as ``golf_tpu``'s ``make_sharded_train_fn`` splits them:

* frame-rate tensors are replicated, sample-rate tensors hold this rank's
  window; ``localize`` turns a replicated frame-rate ``Sig`` into the
  window's sample-rate values (the hop algebra's linear upsample, sliced);
* the all-pole filter exchanges each window's affine end-state map
  ``s_out = M s_in + v`` (``allpole_sharded``: B4's summary entry on the
  card, one all-gather, a local prefix, then B4's re-run entry from the
  incoming state and the summary's chunk maps);
* FIR and framed ops (noise filter, decimation, GOLF-ff's frames, the STFT
  losses) exchange halos of their support with the neighbours, and the
  spectral filters (MLSA, NHV, ∇WORLD) their frames' halos and overlap-add
  spills (``stft_filter_sharded``);
* a composite decoder runs each stage on its unsharded input's length
  (``stage``): past it the window holds zeros, and the spectral filters
  reflect there, as the unsharded stage that an earlier one shortened;
* the phase integrates with a global wrapped cumsum that equals
  ``ops.dsp.wrapped_cumsum`` on the gathered signal bit for bit;
* random fields are drawn over the global (B, T) shape and sliced, so the
  noise does not depend on the layout.

Modules take their sharded branch when ``current()`` returns an env
(``activate``). The collectives are ``parallel.collectives``' (all-reduce
based, differentiable); every rank of a time group runs the same graph, a
rank's position entering through tensors (``torch.where``), never through a
branch around a collective.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.sig import Sig, linear_upsample
from ..ops.allpole import (allpole_rerun_cuda, allpole_stream_plain,
                           allpole_summary_cuda, allpole_summary_plain)
from ..ops.dsp import PHASE_BLOCK, _mod1_scan, get_window_fn, unfold
from . import collectives
from .mesh import Mesh, data_parallel, data_shard, rows_of, shard_batch

_ACTIVE: list = []


@dataclasses.dataclass
class SeqParEnv:
    """One rank's place in a sharded step."""

    n_time: int
    t_global: int            # global sample-rate length
    b_global: int            # global batch
    time_index: int = 0
    time_group: Any = None
    n_data: int = 1
    data_index: int = 0
    # longest prefix of the output that is exactly the unsharded result
    # (coefficient upsampling runs out of frames near the global end and the
    # sharded chain edge-holds instead of truncating; the loss is restricted
    # to it)
    valid_len: Optional[int] = None
    # the steps of the unsharded input of the module being called, when a
    # composite decoder's earlier stage shortened it (``stage``; None: T)
    in_len: Optional[int] = None

    @property
    def t_local(self) -> int:
        return self.t_global // self.n_time

    def shrink_valid(self, n: int) -> None:
        self.valid_len = n if self.valid_len is None else min(
            self.valid_len, n)


def current() -> Optional[SeqParEnv]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def activate(env: SeqParEnv):
    _ACTIVE.append(env)
    try:
        yield env
    finally:
        _ACTIVE.pop()


def env_for(mesh: Mesh, b_global: int, t_global: int,
            valid_len: Optional[int] = None) -> SeqParEnv:
    return SeqParEnv(n_time=mesh.n_time, t_global=t_global,
                     b_global=b_global, time_index=mesh.time_index,
                     time_group=mesh.time_group, n_data=mesh.n_data,
                     data_index=mesh.data_index, valid_len=valid_len)


# ---------------------------------------------------------------------------
# collective helpers
# ---------------------------------------------------------------------------

def tidx(env: SeqParEnv) -> int:
    return env.time_index


def _where(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where this rank's ``cond`` holds, else ``b``; both sides stay in
    the graph, so that every rank runs the same backward collectives."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def halo_left(x: torch.Tensor, n: int, env: SeqParEnv) -> torch.Tensor:
    """The last ``n`` time samples of the left neighbour (zeros on shard
    0). Time is dim 1."""
    if n == 0:
        return x[:, :0]
    return collectives.shift(x[:, -n:], env.time_group, 1)


def halo_right(x: torch.Tensor, n: int, env: SeqParEnv) -> torch.Tensor:
    """The first ``n`` time samples of the right neighbour (zeros on the
    last shard)."""
    if n == 0:
        return x[:, :0]
    return collectives.shift(x[:, :n], env.time_group, -1)


def global_cumsum(x: torch.Tensor, env: SeqParEnv) -> torch.Tensor:
    """Cumsum along global time of a time-sharded (B, T_loc) tensor: the
    local cumsum plus the exclusive prefix of the shards' totals (one small
    all-gather), accumulated in float64 as ``ops.dsp.reversed_cumsum``
    does."""
    loc = torch.cumsum(x.double(), dim=1)
    totals = collectives.all_gather(loc[:, -1:], env.time_group, dim=1)
    mask = (torch.arange(env.n_time, device=x.device)
            < tidx(env)).to(totals.dtype)
    return (loc + (totals @ mask)[:, None]).to(x.dtype)


def global_flip(x: torch.Tensor, env: SeqParEnv) -> torch.Tensor:
    """Reverse the global time axis: flip locally, mirror the shards."""
    return collectives.mirror(torch.flip(x, (1,)), env.time_group)


def global_reversed_cumsum(g: torch.Tensor, env: SeqParEnv) -> torch.Tensor:
    """``out_s = sum_{t >= s} g_t`` along global time, what
    ``global_flip(global_cumsum(global_flip(g)))`` gives: the local reversed
    cumsum plus the totals of the shards to the right (one small
    all-gather), accumulated in float64 as ``ops.dsp.reversed_cumsum``."""
    loc = torch.flip(torch.cumsum(torch.flip(g, (1,)).double(), dim=1),
                     (1,))
    totals = collectives.all_gather(loc[:, :1], env.time_group, dim=1)
    mask = (torch.arange(env.n_time, device=g.device)
            > tidx(env)).to(totals.dtype)
    return (loc + (totals @ mask)[:, None]).to(g.dtype)


class _GlobalWrappedCumsum(torch.autograd.Function):
    """The blocked wrapped cumsum of ``ops.dsp``: per-block local cumsums
    (float64, rounded once a sample), the wrapped block totals gathered,
    and every shard runs the same mod-1 scan over all of them, so the
    outputs round as the unsharded ones do. The backward is the reversed
    global cumsum (``global_reversed_cumsum``)."""

    @staticmethod
    def forward(ctx, x, env, block):
        ctx.env = env
        b, tl = x.shape
        nb = tl // block
        local = torch.cumsum(x.reshape(b, nb, block).double(),
                             dim=-1).to(x.dtype)
        totals = torch.remainder(local[..., -1], 1)
        tot_glob = collectives.all_gather(totals, env.time_group, dim=1)
        off = _mod1_scan(tot_glob)
        off_excl = torch.cat([torch.zeros_like(off[:, :1]), off[:, :-1]],
                             dim=1)
        off_loc = off_excl[:, tidx(env) * nb:(tidx(env) + 1) * nb]
        out = torch.remainder(torch.remainder(local, 1)
                              + off_loc[..., None], 1)
        return out.reshape(b, tl)

    @staticmethod
    def backward(ctx, g):
        return global_reversed_cumsum(g, ctx.env), None, None


def global_wrapped_cumsum(x: torch.Tensor, env: SeqParEnv,
                          block: Optional[int] = None) -> torch.Tensor:
    """Global inclusive cumsum mod 1 of a time-sharded (B, T_loc) tensor,
    equal to ``ops.dsp.wrapped_cumsum`` of the gathered signal bit for bit
    when ``T_loc`` is a multiple of the block; otherwise
    ``global_cumsum(x) % 1``."""
    blk = PHASE_BLOCK if block is None else block
    if x.shape[1] % blk:
        return torch.remainder(global_cumsum(x, env), 1)
    return _GlobalWrappedCumsum.apply(x, env, blk)


def gather_time(x: torch.Tensor, env: SeqParEnv) -> torch.Tensor:
    """(B, T_loc) -> (B, T): the tiled all-gather of the time axis."""
    return collectives.all_gather(x, env.time_group, dim=1)


def gather_sig(sig: Sig, env: SeqParEnv) -> Sig:
    return Sig(gather_time(sig.data, env), sig.hop)


def slice_global_rows(arr: torch.Tensor, env: SeqParEnv) -> torch.Tensor:
    """This data shard's rows of a global-batch tensor."""
    return rows_of(arr, env.data_index, env.n_data)


# ---------------------------------------------------------------------------
# frame rate -> the local window
# ---------------------------------------------------------------------------

def _edge_hold(d: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([d, d[:, -1:].expand(-1, rows, *d.shape[2:])], dim=1)


def localize(sig: Sig, env: SeqParEnv, to_hop: int = 1) -> Sig:
    """Replicated frame-rate ``Sig`` -> this shard's window at ``to_hop``:
    rows ``[k F_loc, k F_loc + F_loc]`` upsampled reproduce the global
    interpolation on samples ``[k T_loc, (k + 1) T_loc)``. Past the last
    row the window edge-holds, and ``env.valid_len`` excludes it."""
    hop = sig.hop
    tl = env.t_local
    if tl % hop or hop % to_hop:
        raise ValueError(f"T_local={tl} must be a multiple of hop={hop} "
                         f"(and hop of {to_hop}) for time sharding")
    f_loc = tl // hop
    need = env.n_time * f_loc + 1
    d = sig.data
    if d.shape[1] < need:
        env.shrink_valid((d.shape[1] - 1) * hop + 1)
        d = _edge_hold(d, need - d.shape[1])
    row0 = tidx(env) * f_loc
    win = d[:, row0:row0 + f_loc + 1]
    if to_hop == hop:
        return Sig(win[:, :f_loc], hop)
    up = linear_upsample(win, hop // to_hop, axis=1)
    return Sig(up[:, :tl // to_hop], to_hop)


def localize_frames(sig: Sig, env: SeqParEnv) -> Sig:
    """Replicated frame-rate ``Sig`` -> this shard's frame rows ``[k F_loc,
    (k + 1) F_loc)``, no upsample."""
    hop = sig.hop
    tl = env.t_local
    if tl % hop:
        raise ValueError(f"T_local={tl} is not a multiple of hop={hop}")
    f_loc = tl // hop
    d = sig.data
    need = env.n_time * f_loc
    if d.shape[1] < need:
        env.shrink_valid(d.shape[1] * hop)
        d = _edge_hold(d, need - d.shape[1])
    return Sig(d[:, tidx(env) * f_loc:(tidx(env) + 1) * f_loc], hop)


def cut_global(x: torch.Tensor, n: int, env: SeqParEnv) -> torch.Tensor:
    """Zero a time-sharded (B, T_loc, ...) tensor at global steps >= n, as
    an unsharded signal of n steps is zero-padded."""
    if n >= env.t_global:
        return x
    tl = x.shape[1]
    g = tidx(env) * tl + torch.arange(tl, device=x.device)
    keep = (g < n).reshape(1, tl, *([1] * (x.ndim - 2)))
    return torch.where(keep, x, torch.zeros_like(x))


def stage(module, x: Sig, params, n_in: int, **kwargs) -> Sig:
    """``module(x, *params)`` as a stage of a composite decoder whose
    unsharded input has ``n_in`` steps: time-sharded, x's steps past n_in
    are zeroed (the unsharded module's zero padding) and ``env.in_len`` is
    n_in while the module runs (the spectral filters reflect there)."""
    env = current()
    if env is None:
        return module(x, *params, **kwargs)
    prev, env.in_len = env.in_len, n_in
    try:
        return module(Sig(cut_global(x.data, n_in, env), x.hop), *params,
                      **kwargs)
    finally:
        env.in_len = prev


def upsample_local(x: torch.Tensor, k: int, env: SeqParEnv) -> torch.Tensor:
    """Align-corners linear upsample by ``k`` of a time-sharded (B, T_loc)
    tensor with a one-sample right halo, exact across shard boundaries.
    (B, T_loc k); global samples past (T - 1) k are zero."""
    if k == 1:
        return x
    nxt = _where(tidx(env) == env.n_time - 1, x[:, -1:],
                 halo_right(x, 1, env))
    up = linear_upsample(torch.cat([x, nxt], dim=1), k, axis=1)
    up = up[:, :x.shape[1] * k]
    gidx = tidx(env) * x.shape[1] * k + torch.arange(x.shape[1] * k,
                                                     device=x.device)
    return torch.where(gidx <= (env.t_global - 1) * k, up,
                       torch.zeros_like(up))


def slice_global_rng(generator: Optional[torch.Generator],
                     shape_global: Tuple[int, int], env: SeqParEnv,
                     kind: str = "normal", dtype=torch.float32,
                     device=None, field: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Draw over the GLOBAL (B, L) shape from ``generator`` (or take the
    given global ``field``) and slice this shard's rows and window, so the
    values do not depend on the layout. L is the length of the unsharded
    draw (the unsharded source's reference, at most T); past it the window
    holds zeros."""
    if field is None:
        draw = torch.randn if kind == "normal" else torch.rand
        if kind not in ("normal", "uniform"):
            raise ValueError(kind)
        field = draw(tuple(shape_global), generator=generator, dtype=dtype,
                     device=device)
    elif tuple(field.shape) != tuple(shape_global):
        raise ValueError(f"noise {tuple(field.shape)} != global "
                         f"{tuple(shape_global)}")
    tl = env.t_local
    rows = rows_of(field, env.data_index, env.n_data)
    rows = F.pad(rows, (0, max(env.n_time * tl - rows.shape[1], 0)))
    return rows[:, tidx(env) * tl:(tidx(env) + 1) * tl].to(device=device,
                                                          dtype=dtype)


# ---------------------------------------------------------------------------
# the all-pole filter across shards
# ---------------------------------------------------------------------------

def incoming_state(m: torch.Tensor, v: torch.Tensor, env: SeqParEnv,
                   reverse: bool = False) -> torch.Tensor:
    """This shard's true incoming state from every shard's summary (M, v)
    of this one's (one all-gather): the composition of the shards before
    this one in the filter's order, the shards to the left, or with
    ``reverse`` (the globally time-reversed problem, whose shards each rank
    holds locally flipped) the shards to the right, nearest last. Returns
    (B, p) in v's dtype."""
    m_all = collectives.all_gather(m[None], env.time_group)
    v_all = collectives.all_gather(v[None], env.time_group)
    k = tidx(env)
    order = range(env.n_time - 1, k, -1) if reverse else range(k)
    s = torch.zeros_like(v)
    for j in order:
        s = torch.einsum("bij,bj->bi", m_all[j], s) + v_all[j]
    return s


def _allpole_sharded_fwd(x: torch.Tensor, a: torch.Tensor, env: SeqParEnv,
                         reverse: bool = False) -> torch.Tensor:
    """Forward on this shard from its true incoming state. On the card B4's
    summary entry (float64) keeps its chunk maps and the re-run entry takes
    them, so phase 1 runs once; on the CPU ``golf_tpu``'s summary and its
    form from the state."""
    if x.is_cuda:
        x, a = x.contiguous(), a.contiguous()
        m, v, maps = allpole_summary_cuda(x, a)
        zi = incoming_state(m, v, env, reverse).to(x.dtype)
        return allpole_rerun_cuda(x, a, zi, maps)
    m, v = allpole_summary_plain(x, a)
    return allpole_stream_plain(x, a,
                                incoming_state(m, v, env, reverse).to(x.dtype))


def _shift_columns_sharded(a: torch.Tensor, env: SeqParEnv) -> torch.Tensor:
    """``ops.allpole._shift_columns`` across shards: c[:, n, j] =
    a_global[:, n + j + 1, j], with a right halo of p rows."""
    p = a.shape[-1]
    ext = torch.cat([a, halo_right(a, p, env)], dim=1)
    t = a.shape[1]
    return torch.stack([ext[:, j + 1:j + 1 + t, j] for j in range(p)],
                       dim=-1)


def _delayed_stack_sharded(y: torch.Tensor, p: int, env: SeqParEnv
                           ) -> torch.Tensor:
    """d[:, n, j] = y_global[:, n - j - 1], with a left halo of p
    samples."""
    ext = torch.cat([halo_left(y, p, env), y], dim=1)
    t = y.shape[1]
    return torch.stack([ext[:, p - j - 1:p - j - 1 + t] for j in range(p)],
                       dim=-1)


class _AllpoleSharded(torch.autograd.Function):
    """``golf_tpu``'s ``_allpole_sharded_vjp``: the adjoint is the sharded
    forward on the globally flipped cotangent with the halo-shifted,
    flipped coefficients (B4 from an incoming state again), and
    ``da = -dx * delayed_stack(y)``. The global flip is a local flip and a
    mirror of the shard order; rather than move the (B, T_loc, p)
    coefficients to the mirrored rank, each rank runs its own flipped
    piece, whose incoming state composes the summaries of the shards to
    its right (``incoming_state(reverse=True)``): the same arithmetic, and
    only the p x (p + 1) summaries cross ranks."""

    @staticmethod
    def forward(ctx, x, a, env):
        y = _allpole_sharded_fwd(x, a, env)
        ctx.save_for_backward(y, a)
        ctx.env = env
        return y

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        env = ctx.env
        c = _shift_columns_sharded(a, env)
        dx = torch.flip(_allpole_sharded_fwd(
            torch.flip(g, (1,)), torch.flip(c, (1,)), env, reverse=True),
            (1,))
        da = -dx[..., None] * _delayed_stack_sharded(y, a.shape[-1], env)
        return dx, da, None


def allpole_sharded(x: torch.Tensor, a: torch.Tensor, env: SeqParEnv
                    ) -> torch.Tensor:
    """Differentiable time-sharded all-pole filter of this shard's x
    (B, T_loc) and coefficients a (B, T_loc, p); float32 on the card."""
    return _AllpoleSharded.apply(x, a, env)


# ---------------------------------------------------------------------------
# FIR and framed ops
# ---------------------------------------------------------------------------

def fir_frame_conv_sharded(x: torch.Tensor, kernels_local: torch.Tensor,
                           hop: int, pad: int, correlate: bool,
                           env: SeqParEnv) -> torch.Tensor:
    """Frame-wise FIR of a time-sharded signal (the LTV zero-phase FIR
    noise filter): the global zero pad ``pad`` left and K - 1 - pad right
    becomes a halo exchange, and each shard convolves its own frames.
    kernels_local: (B, F_loc, K), this shard's rows (``localize_frames``).
    Returns (B, T_loc)."""
    from ..models.filters import _fft_frame_conv
    k = kernels_local.shape[-1]
    tl = x.shape[1]
    f_loc = tl // hop
    right = k - 1 - pad + hop - 1
    ext = torch.cat([halo_left(x, pad, env), x, halo_right(x, right, env)],
                    dim=1)
    frames = unfold(ext, k + hop - 1, hop)[:, :f_loc]
    out = _fft_frame_conv(frames, kernels_local[:, :f_loc], hop, correlate)
    return out.reshape(x.shape[0], tl)


def decimate_sharded(x: torch.Tensor, q: int, env: SeqParEnv,
                     kernel: Optional[np.ndarray] = None) -> torch.Tensor:
    """Anti-aliased decimation of a time-sharded signal ('same'-padded
    lowpass, then every q-th sample: ``ops.resample.decimate``), with halos
    of half the kernel. T_loc must be a multiple of q."""
    from ..ops.resample import sinc_kernel
    if kernel is None:
        kernel = sinc_kernel(q)
    half = (kernel.shape[0] - 1) // 2
    tl = x.shape[1]
    if tl % q:
        raise ValueError(f"T_local={tl} is not a multiple of {q}")
    ext = torch.cat([halo_left(x, half, env), x, halo_right(x, half, env)],
                    dim=1)
    kern = torch.as_tensor(np.asarray(kernel), dtype=x.dtype,
                           device=x.device)
    n = ext.shape[1] + kernel.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    conv = torch.fft.irfft(torch.fft.rfft(ext, n=nfft)
                           * torch.fft.rfft(kern, n=nfft), n=nfft)
    return conv[..., 2 * half:2 * half + tl:q]


def frame_ola_sharded(frames_fn: Callable, exg: torch.Tensor,
                      window: np.ndarray, hop: int, env: SeqParEnv
                      ) -> torch.Tensor:
    """Frame processing and windowed overlap-add of a time-sharded signal
    (GOLF-ff's frame-wise LPC). Frames of W = len(window) samples at stride
    ``hop`` (global zero pad W/2) belong to the shard that holds their
    hop-start; each shard processes its F_loc = T_loc / hop frames with
    ``frames_fn((B, F_loc, W)) -> (B, F_loc, W)``, overlap-adds them into a
    buffer W/2 wider on each side, and hands the spilled edges to its
    neighbours. The global windowed-ones normalisation is sliced per shard.
    (B, T_loc); the global tail past T - hop is excluded by
    ``env.valid_len``."""
    b, tl = exg.shape
    w = window.shape[0]
    pad = w // 2
    if tl % hop or w % hop or pad > tl:
        raise ValueError(f"frame_ola_sharded: T_loc {tl}, hop {hop}, "
                         f"window {w}")
    f_loc = tl // hop
    win = torch.as_tensor(np.asarray(window, np.float64), dtype=exg.dtype,
                          device=exg.device)
    ext = torch.cat([halo_left(exg, pad, env), exg,
                     halo_right(exg, pad, env)], dim=1)
    frames = unfold(ext, w, hop)[:, :f_loc]
    filtered = frames_fn(frames) * win
    # strip j of every frame lands on one contiguous stride-hop run of the
    # buffer [k T_loc - pad, (k + 1) T_loc + pad)
    buf = 0
    for j in range(w // hop):
        strip = filtered[:, :, j * hop:(j + 1) * hop].reshape(b, tl)
        buf = buf + F.pad(strip, (j * hop, 2 * pad - j * hop))
    from_left = halo_left(buf[:, -pad:], pad, env)
    from_right = halo_right(buf[:, :pad], pad, env)
    y = (buf[:, pad:-pad] + F.pad(from_left, (0, tl - pad))
         + F.pad(from_right, (tl - pad, 0)))
    f_glob = env.n_time * f_loc
    norm = ola_norm(np.asarray(window, np.float64), hop, f_glob, env,
                    1e-9, exg)
    env.shrink_valid((f_glob - 1) * hop)
    return y / norm[None, :]


_NORMS: Dict[tuple, torch.Tensor] = {}


def ola_norm(window: np.ndarray, hop: int, f_glob: int, env: SeqParEnv,
             floor: float, like: torch.Tensor) -> torch.Tensor:
    """This shard's slice of the global overlap-add normalisation: ``window``
    added at every one of the ``f_glob`` frames' hop-starts (float64, in the
    frames' order, floored at ``floor``), over the padded signal and
    trimmed by half the window on each side, then cut to the shard's window
    of samples. Built once per window, layout and device and kept there."""
    key = (window.tobytes(), hop, f_glob, env.t_global, env.n_time,
           tidx(env), floor, like.dtype, like.device)
    seg = _NORMS.get(key)
    if seg is None:
        w = window.shape[0]
        pad = w // 2
        norm = np.zeros(env.t_global + 2 * pad)
        idx = (np.arange(f_glob)[:, None] * hop
               + np.arange(w)[None, :]).reshape(-1)
        np.add.at(norm, idx, np.tile(window, f_glob))
        norm = np.maximum(norm[pad:pad + env.t_global], floor)
        tl = env.t_local
        seg = torch.as_tensor(norm[tidx(env) * tl:(tidx(env) + 1) * tl],
                              dtype=like.dtype, device=like.device)
        _NORMS[key] = seg
    return seg


def stft_filter_sharded(x: torch.Tensor, h_local: torch.Tensor, n_fft: int,
                        hop: int, window: str, env: SeqParEnv,
                        onesided: bool = True, n_in: Optional[int] = None,
                        n_frames: Optional[int] = None) -> torch.Tensor:
    """STFT-domain LTV filtering of a time-sharded signal (the MLSA,
    NHV-cepstral and ∇WORLD filters): analysis window, FFT, a product with
    the frame's transfer, inverse FFT, synthesis window, and the
    overlap-add divided by the window-square sum (``ops.stft``'s stft and
    istft, centred with reflect padding).

    Global frame f (hop-start f hop in padded coordinates) belongs to shard
    f // F_loc, F_loc = T_loc / hop; ``h_local`` (B, F_loc, bins) holds
    this shard's rows, real or complex, with n_fft // 2 + 1 bins when
    ``onesided``, else n_fft. The frames read a halo of n_fft // 2 samples
    on each side, their overlap-add spills as far into the neighbours, and
    the normalisation counts the global frames. The unsharded signal has
    ``n_in`` steps (T by default): the first shard reflects its own first
    samples, and the signal past n_in is its reflection there, on the last
    shard. Only the first ``n_frames`` global frames are added (all n F_loc
    by default), as the unsharded filter's ``min(spectrum frames, ctrl
    frames)``; its istft ends at (n_frames - 1) hop + n_fft - 2 (n_fft //
    2), and ``env.valid_len`` shrinks to it. (B, T_loc)."""
    b, tl = x.shape
    pad = n_fft // 2
    n_in = env.t_global if n_in is None else n_in
    f_loc = tl // hop
    k = tidx(env)
    is_last = k == env.n_time - 1
    last0 = (env.n_time - 1) * tl
    if tl % hop or pad > tl - 2 or not last0 + pad + 2 <= n_in <= \
            env.t_global:
        raise ValueError(f"stft_filter_sharded: T_loc {tl}, hop {hop}, "
                         f"n_fft {n_fft}, n_in {n_in}")
    n_frames = env.n_time * f_loc if n_frames is None else n_frames
    win_np = np.asarray(get_window_fn(window)(n_fft), np.float64)
    win = torch.as_tensor(win_np, dtype=x.dtype, device=x.device)
    # padded coordinates [k T_loc, (k + 1) T_loc + 2 pad): padded[j] =
    # x[pad - j] at the start, and past n_in the reflection x[2 (n_in - 1)
    # - g] of global step g, which lies on the last shard
    left = _where(k == 0, torch.flip(x[:, 1:pad + 1], (1,)),
                  halo_left(x, pad, env))
    ext = torch.cat([left, x, halo_right(x, pad, env)], dim=1)
    g = k * tl - pad + torch.arange(tl + 2 * pad, device=x.device)
    src = torch.clamp(2 * (n_in - 1) - g - last0, 0, tl - 1)
    ext = _where(is_last, torch.where(g >= n_in, x[:, src], ext), ext)
    frames = unfold(ext, n_fft, hop)[:, :f_loc] * win
    h = h_local[:, :f_loc]
    if onesided:
        out_f = torch.fft.irfft(torch.fft.rfft(frames) * h, n=n_fft)
    else:
        out_f = torch.fft.ifft(torch.fft.fft(frames) * h).real
    used = (k * f_loc + torch.arange(f_loc, device=x.device)) < n_frames
    out_f = out_f.to(x.dtype) * win * used[:, None].to(x.dtype)
    # overlap-add in strips of one hop (``ops.stft.istft``'s order) into
    # [k T_loc - pad, (k + 1) T_loc + pad), then the spilled edges go to
    # the neighbours
    q = -(-n_fft // hop)
    fr = F.pad(out_f, (0, q * hop - n_fft)).reshape(b, f_loc, q, hop)
    buf = out_f.new_zeros((b, f_loc + q, hop))
    for j in range(q):
        buf[:, j:j + f_loc] += fr[:, :, j]
    buf = buf.reshape(b, -1)[:, :tl + 2 * pad]
    from_left = halo_left(buf[:, -pad:], pad, env)
    from_right = halo_right(buf[:, :pad], pad, env)
    y = (buf[:, pad:-pad] + F.pad(from_left, (0, tl - pad))
         + F.pad(from_right, (tl - pad, 0)))
    norm = ola_norm(win_np * win_np, hop, n_frames, env, 1e-11, y)
    env.shrink_valid((n_frames - 1) * hop + n_fft - 2 * pad)
    return y / norm[None, :]


# ---------------------------------------------------------------------------
# the STFT loss
# ---------------------------------------------------------------------------

def sharded_frames(x: torch.Tensor, n_fft: int, hop: int, env: SeqParEnv,
                   valid_len: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """This shard's STFT frames of the global valid signal (center=True,
    reflect padding), with halo exchange. Returns (frames (B, F_max,
    n_fft), mask (F_max,), f_global); masked slots are garbage and must be
    left out of reductions. Frame f belongs to the shard that holds its
    unpadded start f hop - n_fft/2 (the early frames to shard 0)."""
    b, tl = x.shape
    n = env.n_time
    pad = n_fft // 2
    k = tidx(env)
    is_last = k == n - 1
    tail_invalid = n * tl - valid_len
    if tl < n_fft + hop or tail_invalid >= tl or \
            tl - tail_invalid < n_fft + hop + 2:
        raise ValueError(f"sharded_frames: T_loc {tl}, n_fft {n_fft}, "
                         f"invalid tail {tail_invalid}")
    f_global = 1 + (valid_len + 2 * pad - n_fft) // hop
    f_max = tl // hop + 2
    dev = x.device

    halo_r = halo_right(x, min(tl, n_fft + hop), env)
    # the last shard reflects its valid tail: padded[T_valid + pad + j] =
    # x[T_valid - 2 - j]
    tv_loc = tl - tail_invalid
    ridx = torch.arange(halo_r.shape[1], device=dev)
    refl_src = torch.clamp(tv_loc - 2 - tail_invalid - ridx, 0, tl - 1)
    halo_r = _where(is_last, x[:, refl_src], halo_r)
    own = x
    if tail_invalid > 0:
        jj = torch.arange(tl, device=dev)
        own_refl = torch.clamp(2 * (tv_loc - 1) - jj, 0, tl - 1)
        own = torch.where((jj >= tv_loc)[None, :] & is_last, x[:, own_refl],
                          x)
    # buf[s] holds padded coordinate k T_loc + s: the left neighbour's tail
    # (or, on shard 0, the reflect pad of its own first samples), then its
    # own samples and the right halo
    left_part = _where(k == 0, torch.flip(x[:, 1:pad + 1], (1,)),
                       halo_left(x, pad, env))
    buf = torch.cat([left_part, own, halo_r], dim=1)
    first_f = 0 if k == 0 else -(-(k * tl) // hop)
    f_ids = first_f + torch.arange(f_max, device=dev)
    next_first = -(-((k + 1) * tl) // hop)
    mask = f_ids < (f_global if is_last else min(next_first, f_global))
    starts = torch.clamp(f_ids * hop - k * tl, 0, buf.shape[1] - n_fft)
    idx = starts[:, None] + torch.arange(n_fft, device=dev)[None, :]
    return buf[:, idx], mask.to(x.dtype), f_global


def sss_loss_sharded(pred: torch.Tensor, target: torch.Tensor, n_fft: int,
                     hop: int, alpha: float, window: str, eps: float,
                     env: SeqParEnv) -> torch.Tensor:
    """The sharded SSSLoss (|STFT| L1 + alpha log2-magnitude L1), equal to
    the unsharded value on the global valid prefix: the lin and log sums
    are summed over the time group before the division."""
    valid = env.valid_len or env.t_global
    w = torch.as_tensor(get_window_fn(window)(n_fft), dtype=pred.dtype,
                        device=pred.device)
    fp, mask, f_glob = sharded_frames(pred, n_fft, hop, env, valid)
    ft, _, _ = sharded_frames(target, n_fft, hop, env, valid)
    sp = torch.abs(torch.fft.rfft(fp * w))
    st = torch.abs(torch.fft.rfft(ft * w))
    m = mask[None, :, None]
    lin = torch.sum(torch.abs(sp - st) * m)
    log = torch.sum(torch.abs(torch.log2(st + eps) - torch.log2(sp + eps))
                    * m)
    lin = collectives.psum(lin, env.time_group)
    log = collectives.psum(log, env.time_group)
    denom = pred.shape[0] * f_glob * (n_fft // 2 + 1)
    return (lin + alpha * log) / denom


# ---------------------------------------------------------------------------
# the (data x time) training step
# ---------------------------------------------------------------------------

def pad_to_alignment(x, f0, n_time: int, align: int):
    """Pad a (B, T) batch of any length for the sharded step: T to the next
    multiple of ``n_time * align`` (``align`` the LCM of the model's frame
    hops: 2400 for GOLF's 240 x hop_rate 10). Audio is zero-padded, f0
    edge-held (a zero run would turn the tail unvoiced and change the
    oscillator's phase history). Returns (x, f0, T); the sharded step on
    the padded batch equals the single-device step on it."""
    t = x.shape[1]
    unit = n_time * align
    t_pad = -(-t // unit) * unit
    if t_pad == t:
        return x, f0, t
    x = F.pad(x, (0, t_pad - t))
    f0 = torch.cat([f0, f0[:, -1:].expand(-1, t_pad - t)], dim=1)
    return x, f0, t


def unsharded_decode_len(decoder, ctrl: Dict, t_phase: int,
                         voicing: Optional[Sig]) -> int:
    """The output length of the unsharded decoder on the global shapes, the
    modules' ``out_len`` composed (``golf_tpu`` takes it from
    ``jax.eval_shape``; the card's kernels do not run on the meta device).
    The single-device step's loss covers exactly this support, so the
    sharded loss's ``valid_len`` starts from it: a module's own shrink can
    miss where its unsharded twin truncates after an upstream stage has
    already shortened the signal (the MLSA and NHV istft). A module without
    ``out_len`` raises ``NotImplementedError`` with its class name."""
    out_len = getattr(decoder, "out_len", None)
    if out_len is None:
        raise NotImplementedError(
            f"time sharding has no output length for "
            f"{type(decoder).__name__}")
    return out_len(t_phase, voicing=voicing, **ctrl)


def make_sharded_train_step(task, mesh: Mesh,
                            pad_align: Optional[int] = None) -> Callable:
    """The full-model training step over a (data x time) mesh
    (``golf_tpu``'s ``make_sharded_train_fn``).

    * The encoder, the ctrl transforms and the aux losses run on every time
      rank over its data shard's rows, data-parallel over the data group
      (global batch norms and f0 loss);
    * the sample-rate decoder and the MSS loss run on this rank's time
      window under ``activate(env)``;
    * each rank's backward is of ``loss / n_time`` (its time group sums the
      parts), and the gradients are summed over the world and divided by
      the data ranks: summed over time, averaged over data.

    Returns ``step(x, f0, generator=None, noise=None, random_f0=None) ->
    (loss, grads, metrics)`` on GLOBAL (B, T) tensors (every rank passes
    the whole batch); ``grads`` maps each trainable parameter's name to its
    gradient, ``metrics`` holds floats. ``noise`` (B, T) and ``random_f0``
    (B, 1), when given, are global fields in place of the generator's
    draws. With ``pad_align`` a batch of any length is padded first
    (``pad_to_alignment``)."""
    named = [(n, p) for n, p in task.named_parameters() if p.requires_grad]
    shard = data_shard(mesh)

    def step(x: torch.Tensor, f0: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             random_f0: Optional[torch.Tensor] = None):
        if pad_align is not None:
            x, f0, _ = pad_to_alignment(x, f0, mesh.n_time, pad_align)
        b_glob, t_glob = x.shape
        x_rows, f0_rows = shard_batch(mesh, x, f0)
        for _, p in named:
            p.grad = None
        task.train()
        with data_parallel(shard):
            if random_f0 is not None:
                random_f0 = rows_of(random_f0, mesh.data_index, mesh.n_data)
            params, f0_hat, voicing_logits = task.prepare_training(
                Sig(x_rows, 1), Sig(f0_rows, 1), True, generator, random_f0)
            raw = {k: v for k, v in params.items() if k.endswith("_params")}
            other = {k: v for k, v in params.items()
                     if not k.endswith("_params")}
            ctrl = task.decoder.apply_ctrl(raw)
            phase = other.pop("phase")
            if phase.hop != 1:
                raise ValueError("time sharding expects a sample-rate phase")
            voicing = other.pop("voicing", None)
            if other:
                raise ValueError(f"unexpected decoder inputs: {list(other)}")
            valid0 = unsharded_decode_len(task.decoder, ctrl, phase.shape[1],
                                          voicing)
            env = env_for(mesh, b_glob, t_glob, valid0)
            tl = env.t_local
            k = mesh.time_index
            x_loc = x_rows[:, k * tl:(k + 1) * tl]
            with activate(env):
                x_hat = task.decoder(
                    phase=Sig(phase.data[:, k * tl:(k + 1) * tl], 1),
                    voicing=voicing, generator=generator, noise=noise,
                    **ctrl)
                t = min(x_hat.shape[1], x_loc.shape[1])
                mss = task.criterion(x_hat.data[:, :t], x_loc[:, :t])
            aux, metrics = task.aux_losses(f0_hat, voicing_logits, ctrl,
                                           Sig(f0_rows, 1))
        loss = mss + aux
        (loss / mesh.n_time).backward()
        summed = collectives.psum_all(
            (torch.zeros_like(p) if p.grad is None else p.grad
             for _, p in named), mesh.world_group)
        grads = {name: g / mesh.n_data for (name, _), g in zip(named, summed)}
        metrics["loss"] = loss
        out = {}
        with torch.no_grad():
            for key, v in metrics.items():
                v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
                out[key] = float(collectives.pmean(v.detach(),
                                                   mesh.data_group))
        return out["loss"], grads, out

    return step
