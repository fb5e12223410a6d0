"""Bilinear wavetable lookup on blocked phase and its adjoint (counterpart
of ``golf_tpu.models.synth._lookup_blocks`` and
``golf_tpu.ops.lookup_pallas``).

For ph (B, blocks, hop) in [0, 1) and tables (B, >= blocks+1, S), sample i
of block f blends table rows f and f+1 with row weight i/hop, at column
ph*S, with column S wrapping to 0.

Three functions, each a hand-written CUDA kernel with a plain PyTorch
version beside it (a CUDA tensor goes to the kernel, a CPU tensor to the
plain version):
* the forward (B1, ``kernels/csrc/lookup.cu``);
* the forward with the corner differences ``d_top = v01 - v00`` and
  ``d_bot = v11 - v10`` (B3a, the same source), which make the phase
  cotangent elementwise (``dph_from_res``);
* the table cotangent (B3b, ``kernels/csrc/lookup_dtab.cu``): a per-block
  histogram of the four corner weights, folded into rows f and f+1 (inside
  the kernel; ``fold_rows`` in the plain version).

``lookup_blocks`` runs B1 when nothing needs a gradient, else the
``torch.autograd.Function`` whose backward is ``golf_tpu``'s custom VJP:
its forward runs B3a and saves the residuals when the phase needs a
gradient (the backward then adds ``dph_from_res``), and B1 when only the
tables do; the table cotangent is B3b's in both.

B1 and B3a split each (batch, block) over several CTAs; ``plan_split``
chooses the split from the shape and the card's SM count.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..kernels import LOOKUP, LOOKUP_DTAB, LOOKUP_RES
from ._checks import check_kernel_inputs

# shared memory one Hopper CTA may use (227 KB)
MAX_SHARED_BYTES = 232448


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _columns(ph: torch.Tensor, s: int):
    """c0 (clamped), the wrapped c1 and the column weight cw."""
    col = ph * s
    c0f = torch.clamp(torch.floor(col), 0, s - 1)
    c0 = c0f.long()
    c1 = torch.where(c0 + 1 == s, 0, c0 + 1)
    return c0, c1, col - c0f


def _row_weight(ph: torch.Tensor, hop: int) -> torch.Tensor:
    return torch.arange(hop, dtype=ph.dtype, device=ph.device) / hop


def _corners(ph: torch.Tensor, tables: torch.Tensor):
    """The four corner values of every sample and its column weight."""
    blocks = ph.shape[1]
    c0, c1, cw = _columns(ph, tables.shape[-1])
    tab0 = tables[:, :blocks]
    tab1 = tables[:, 1:blocks + 1]
    return (torch.gather(tab0, 2, c0), torch.gather(tab0, 2, c1),
            torch.gather(tab1, 2, c0), torch.gather(tab1, 2, c1), cw)


def _blend(v00, v01, v10, v11, cw, rw):
    top = v00 * (1 - cw) + v01 * cw
    bot = v10 * (1 - cw) + v11 * cw
    return top * (1 - rw) + bot * rw


def lookup_blocks_plain(ph: torch.Tensor, tables: torch.Tensor,
                        hop: int) -> torch.Tensor:
    """Four gathers (B1's plain version)."""
    v00, v01, v10, v11, cw = _corners(ph, tables)
    return _blend(v00, v01, v10, v11, cw, _row_weight(ph, hop))


def lookup_res_plain(ph: torch.Tensor, tables: torch.Tensor, hop: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3a's plain version: (out, d_top, d_bot)."""
    v00, v01, v10, v11, cw = _corners(ph, tables)
    out = _blend(v00, v01, v10, v11, cw, _row_weight(ph, hop))
    return out, v01 - v00, v11 - v10


def fold_rows(hist: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, blocks, 2, S) per-block cotangents of rows f and f+1 ->
    (B, frames, S), in ``golf_tpu``'s order (row f's adds, then row
    f+1's)."""
    b, blocks, _, s = hist.shape
    d = hist.new_zeros((b, frames, s))
    d[:, :blocks] += hist[:, :, 0]
    d[:, 1:blocks + 1] += hist[:, :, 1]
    return d


def lookup_dtab_plain(ph: torch.Tensor, g: torch.Tensor, hop: int,
                      frames: int, s: int) -> torch.Tensor:
    """B3b's plain version: the table cotangent (B, frames, S) by
    ``scatter_add_`` of the four corner weights."""
    b, blocks, _ = ph.shape
    c0, c1, cw = _columns(ph, s)
    rw = _row_weight(ph, hop)
    g0 = g * (1 - rw)
    g1 = g * rw
    hist = g0.new_zeros((b, blocks, 2 * s))
    hist.scatter_add_(2, c0, g0 * (1 - cw))
    hist.scatter_add_(2, c1, g0 * cw)
    hist.scatter_add_(2, c0 + s, g1 * (1 - cw))
    hist.scatter_add_(2, c1 + s, g1 * cw)
    return fold_rows(hist.view(b, blocks, 2, s), frames)


def dph_from_res(g: torch.Tensor, d_top: torch.Tensor, d_bot: torch.Tensor,
                 s: int, hop: int) -> torch.Tensor:
    """Elementwise phase cotangent from the saved corner differences
    (``lookup_pallas.py:288-292``)."""
    rw = _row_weight(g, hop)
    return g * s * ((1 - rw) * d_top + rw * d_bot)


# ---------------------------------------------------------------------------
# The grid of B1 and B3a
# ---------------------------------------------------------------------------

MAX_GRID_X = 2 ** 31 - 1    # CUDA's limits on gridDim.x and gridDim.y
MAX_GRID_Y = 65535


class LookupPlan(NamedTuple):
    """``splits`` CTAs a (batch, block), each taking ``piece`` contiguous
    samples of the block (the last one the rest)."""
    splits: int
    piece: int

    def pieces(self, hop: int) -> List[Tuple[int, int]]:
        """Each CTA's [start, stop) within a block of ``hop`` samples."""
        return [(k * self.piece, min((k + 1) * self.piece, hop))
                for k in range(self.splits)]


@functools.lru_cache(maxsize=256)
def plan_split(batch: int, blocks: int, hop: int, s: int,
               n_sm: int) -> LookupPlan:
    """The split of B1's and B3a's grid for ph (batch, blocks, hop) and
    tables of width ``s`` on a card of ``n_sm`` SMs.

    The rule: at least one CTA for every SM (as far as the shape has
    pieces of one unit), otherwise ``ceil(hop / s)`` pieces a block, of
    about ``s`` samples or fewer; pieces are whole 16-byte units (4
    samples) where ``hop % 4 == 0``.
    ``tools/lookup_split_sweep.py`` chose it on an H100 (132 SMs, S =
    2048): 11 pieces of 876 samples at a push (4, 3, 9600) were the
    fastest of 1 to 48 pieces, and 5 pieces of 1920 at serving (4, 60,
    9600) and training (64, 20, 9600) the fastest of 1 to 24 (PERF.md,
    section 6)."""
    cells = batch * blocks
    unit = 4 if hop % 4 == 0 else 1
    units = -(-hop // unit)
    target = min(n_sm, cells * units)
    want = max(-(-hop // s), -(-n_sm // cells))
    while True:
        piece = unit * -(-units // min(want, units))
        plan = LookupPlan(-(-hop // piece), piece)
        if cells * plan.splits >= target:
            return plan
        want += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_grid(name: str, batch: int, blocks: int, plan: LookupPlan) -> None:
    """B1's and B3a's grid is (splits x blocks, batch)."""
    if batch > MAX_GRID_Y or plan.splits * blocks > MAX_GRID_X:
        raise ValueError(f"{name}: the grid ({plan.splits} x {blocks}, "
                         f"{batch}) exceeds CUDA's limits ({MAX_GRID_X}, "
                         f"{MAX_GRID_Y})")


def cuda_plan(ph: torch.Tensor, tables: torch.Tensor) -> LookupPlan:
    """The split B1 and B3a launch with for these operands."""
    b, blocks, hop = ph.shape
    return plan_split(b, blocks, hop, tables.shape[2],
                      sm_count(ph.device.index))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_blocks(name: str, ph: torch.Tensor, hop: int, s: int) -> None:
    if ph.ndim != 3 or ph.shape[2] != hop:
        raise ValueError(f"{name}: ph must be (B, blocks, {hop}), got "
                         f"{tuple(ph.shape)}")
    if s < 1 or 8 * s > MAX_SHARED_BYTES or ph.shape[0] > 65535:
        raise ValueError(f"{name}: two table rows of S = {s} must fit in "
                         f"shared memory and B <= 65535")


def _check_tables(name: str, ph: torch.Tensor, tables: torch.Tensor,
                  hop: int) -> None:
    check_kernel_inputs(name, ph=ph, tables=tables)
    b, blocks = ph.shape[:2]
    if (tables.ndim != 3 or tables.shape[0] != b
            or tables.shape[1] < blocks + 1):
        raise ValueError(f"{name}: tables must be ({b}, >= {blocks + 1}, S), "
                         f"got {tuple(tables.shape)}")
    _check_blocks(name, ph, hop, tables.shape[2])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lookup_blocks_cuda(ph: torch.Tensor, tables: torch.Tensor,
                       hop: int) -> torch.Tensor:
    """B1: fp32 contiguous CUDA tensors, tables with at least blocks+1
    rows."""
    _check_tables("lookup", ph, tables, hop)
    b, blocks, _ = ph.shape
    out = torch.empty_like(ph)
    if ph.numel():
        plan = cuda_plan(ph, tables)
        check_grid("lookup", b, blocks, plan)
        LOOKUP.launch(ph.data_ptr(), tables.data_ptr(), out.data_ptr(), b,
                      blocks, hop, tables.shape[1], tables.shape[2],
                      plan.splits, plan.piece, ph.device.index, _stream(ph),
                      shapes=(tuple(ph.shape), tuple(tables.shape)))
    return out


def lookup_res_cuda(ph: torch.Tensor, tables: torch.Tensor, hop: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3a: B1 plus the corner differences; returns (out, d_top, d_bot)."""
    _check_tables("lookup_res", ph, tables, hop)
    b, blocks, _ = ph.shape
    out, d_top, d_bot = (torch.empty_like(ph) for _ in range(3))
    if ph.numel():
        plan = cuda_plan(ph, tables)
        check_grid("lookup_res", b, blocks, plan)
        LOOKUP_RES.launch(ph.data_ptr(), tables.data_ptr(), out.data_ptr(),
                          d_top.data_ptr(), d_bot.data_ptr(), b, blocks, hop,
                          tables.shape[1], tables.shape[2], plan.splits,
                          plan.piece, ph.device.index, _stream(ph),
                          shapes=(tuple(ph.shape), tuple(tables.shape)))
    return out, d_top, d_bot


def lookup_dtab_cuda(ph: torch.Tensor, g: torch.Tensor, hop: int,
                     frames: int, s: int) -> torch.Tensor:
    """B3b: the table cotangent (B, frames, S) of the output cotangent
    ``g``; the kernel adds each block's histogram into rows f and f+1 of
    the zeroed result."""
    check_kernel_inputs("lookup_dtab", ph=ph, g=g)
    _check_blocks("lookup_dtab", ph, hop, s)
    b, blocks, _ = ph.shape
    if g.shape != ph.shape or frames < blocks + 1:
        raise ValueError(f"lookup_dtab: g {tuple(g.shape)} must match ph "
                         f"{tuple(ph.shape)} and frames {frames} >= "
                         f"{blocks + 1}")
    d = torch.zeros((b, frames, s), dtype=ph.dtype, device=ph.device)
    if ph.numel():
        LOOKUP_DTAB.launch(ph.data_ptr(), g.data_ptr(), d.data_ptr(), b,
                           blocks, hop, frames, s, ph.device.index,
                           _stream(ph),
                           shapes=(tuple(ph.shape), (b, frames, s)))
    return d


# ---------------------------------------------------------------------------
# Dispatch and the adjoint
# ---------------------------------------------------------------------------

class LookupOps(NamedTuple):
    """The three functions of one route: forward, forward with residuals,
    table cotangent."""
    fwd: Callable
    res: Callable
    dtab: Callable


CUDA_OPS = LookupOps(lookup_blocks_cuda, lookup_res_cuda, lookup_dtab_cuda)
PLAIN_OPS = LookupOps(lookup_blocks_plain, lookup_res_plain,
                      lookup_dtab_plain)


class _LookupBlocks(torch.autograd.Function):
    """``golf_tpu``'s ``_lookup_blocks`` custom VJP (models/synth.py:
    118-153): when the phase needs a gradient the forward saves the corner
    differences (B3a) and the backward adds ``dph_from_res``; else the
    forward is B1 and only the phase is saved. The table cotangent is
    B3b's either way."""

    @staticmethod
    def forward(ctx, ph, tables, hop, ops):
        if ctx.needs_input_grad[0]:
            out, d_top, d_bot = ops.res(ph, tables, hop)
            ctx.save_for_backward(ph, d_top, d_bot)
        else:
            out = ops.fwd(ph, tables, hop)
            ctx.save_for_backward(ph)
        ctx.hop, ctx.ops = hop, ops
        ctx.frames, ctx.s = tables.shape[1], tables.shape[2]
        return out

    @staticmethod
    def backward(ctx, g):
        ph, *res = ctx.saved_tensors
        g = g.contiguous()
        d_ph = d_tab = None
        if ctx.needs_input_grad[0]:
            d_ph = dph_from_res(g, *res, ctx.s, ctx.hop)
        if ctx.needs_input_grad[1]:
            d_tab = ctx.ops.dtab(ph, g, ctx.hop, ctx.frames, ctx.s)
        return d_ph, d_tab, None, None


def lookup_blocks(ph: torch.Tensor, tables: torch.Tensor, hop: int,
                  ops: Optional[LookupOps] = None) -> torch.Tensor:
    """The lookup on the route of the tensors' device (``ops`` names a
    route explicitly, for comparisons on the card). Differentiable: when
    the phase needs a gradient the forward runs B3a and saves its
    residuals, as ``golf_tpu`` does; when only the tables need one (the
    phase of the true f0, as on the Interspeech24 path) it runs B1 and
    saves the phase alone."""
    if ops is None:
        ops = CUDA_OPS if ph.is_cuda else PLAIN_OPS
    if torch.is_grad_enabled() and (ph.requires_grad or tables.requires_grad):
        return _LookupBlocks.apply(ph, tables, hop, ops)
    return ops.fwd(ph, tables, hop)
