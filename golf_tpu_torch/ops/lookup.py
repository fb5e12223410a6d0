"""Bilinear wavetable lookup on blocked phase, forward (counterpart of
``golf_tpu.models.synth._lookup_blocks_jnp`` and
``golf_tpu.ops.lookup_pallas.bilinear_lookup_pallas``).

For ph (B, blocks, hop) in [0, 1) and tables (B, >= blocks+1, S), sample i
of block f blends table rows f and f+1 with row weight i/hop, at column
ph*S, with column S wrapping to 0. A CUDA tensor goes to the hand-written
kernel (``kernels/csrc/lookup.cu``), a CPU tensor to the plain version.
The kernel has no backward yet.
"""

from __future__ import annotations

import torch

from ..kernels import LOOKUP
from ._checks import check_kernel_inputs

# shared memory one Hopper CTA may use (227 KB)
MAX_SHARED_BYTES = 232448


def lookup_blocks_plain(ph: torch.Tensor, tables: torch.Tensor,
                        hop: int) -> torch.Tensor:
    """Four gathers on the wrap-padded table rows."""
    blocks = ph.shape[1]
    s = tables.shape[-1]
    padded = torch.cat([tables, tables[:, :, :1]], dim=2)   # (B, F, S+1)
    col = ph * s
    c0f = torch.clamp(torch.floor(col), 0, s - 1)
    c0 = c0f.long()
    cw = col - c0f
    tab0 = padded[:, :blocks]
    tab1 = padded[:, 1:blocks + 1]
    v00 = torch.gather(tab0, 2, c0)
    v01 = torch.gather(tab0, 2, c0 + 1)
    v10 = torch.gather(tab1, 2, c0)
    v11 = torch.gather(tab1, 2, c0 + 1)
    top = v00 * (1 - cw) + v01 * cw
    bot = v10 * (1 - cw) + v11 * cw
    rw = (torch.arange(hop, dtype=ph.dtype, device=ph.device) / hop)
    return top * (1 - rw) + bot * rw


def lookup_blocks_cuda(ph: torch.Tensor, tables: torch.Tensor,
                       hop: int) -> torch.Tensor:
    """Kernel wrapper: fp32 contiguous CUDA tensors, tables with at least
    blocks+1 rows."""
    check_kernel_inputs("lookup", ph=ph, tables=tables)
    if ph.ndim != 3 or ph.shape[2] != hop:
        raise ValueError(f"lookup: ph must be (B, blocks, {hop}), got "
                         f"{tuple(ph.shape)}")
    b, blocks, _ = ph.shape
    if (tables.ndim != 3 or tables.shape[0] != b
            or tables.shape[1] < blocks + 1 or tables.shape[2] < 1):
        raise ValueError(f"lookup: tables must be ({b}, >= {blocks + 1}, S), "
                         f"got {tuple(tables.shape)}")
    if 8 * tables.shape[2] > MAX_SHARED_BYTES or b > 65535:
        raise ValueError(f"lookup: two table rows of S = {tables.shape[2]} "
                         f"must fit in shared memory and B <= 65535")
    out = torch.empty_like(ph)
    if ph.numel():
        LOOKUP.launch(ph.data_ptr(), tables.data_ptr(), out.data_ptr(), b,
                      blocks, hop, tables.shape[1], tables.shape[2],
                      ph.device.index,
                      torch.cuda.current_stream(ph.device).cuda_stream,
                      shapes=(tuple(ph.shape), tuple(tables.shape)))
    return out


def lookup_blocks(ph: torch.Tensor, tables: torch.Tensor,
                  hop: int) -> torch.Tensor:
    if ph.is_cuda:
        return lookup_blocks_cuda(ph, tables, hop)
    return lookup_blocks_plain(ph, tables, hop)
