"""The encoder's conv pyramid stage, forward (``models/unet.py::
ConvPyramid``; ``golf_tpu`` runs it as flax ``Conv``s under XLA, no Pallas
site).

A stage is Conv2d((2s + 1, 3), padding (s, 1)) over NCHW (B, C, F, T),
batch norm, ReLU and the floor max-pool by s over F. Two functions, each
a hand-written CUDA kernel (``kernels/csrc/pyramid_conv.cu``) with a plain
PyTorch version beside it (a CUDA tensor goes to the kernel, a CPU tensor
to the plain version):
* ``pyramid_conv(x, weight, bias)``: the convolution and its bias, a
  ``torch.autograd.Function`` whose backward is the convolution's own
  (``aten.convolution_backward``, as ``F.conv2d``'s autograd runs it);
* ``pyramid_stage_eval(x, conv, norm, s)``: the whole stage with the batch
  norm's running statistics, no gradient; the kernel applies the norm,
  ReLU and the pool in its epilogue and writes only (B, C', F // s, T).

Both kernels take fp32 only, contiguous, s = 1 to 4; the wrappers raise
on anything else. ``plan_conv`` chooses the kernel's tile from the shape
and the card's SM count.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import PYRAMID_CONV, PYRAMID_CONV_EVAL
from ._checks import check_kernel_inputs

MAX_S = 4            # the strides the kernel is instantiated for
THREADS = 256        # a CTA (kThreads in pyramid_conv.cu)
CO_THREAD = 8        # output channels a thread owns
# two stages of shared memory per CTA, so that two CTAs fit an SM
# (__launch_bounds__(256, 2): 128 registers a thread)
STAGES_BYTES = 112 * 1024
MAX_GRID = 65535     # CUDA's limit on gridDim.y (output-channel tiles), .z
MAX_CHUNK = 8
# issue slots a copied float costs against one FFMA, in the planner's cost
LOAD_COST = 8


def strided_max(x: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """Max-pool with window == stride along ``axis`` (floor)."""
    if s == 1:
        return x
    x = x.movedim(axis, -1)
    frames = x.shape[-1] // s
    x = x[..., :frames * s].reshape(*x.shape[:-1], frames, s).amax(dim=-1)
    return x.movedim(-1, axis)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _stride_of(weight: torch.Tensor) -> int:
    return (weight.shape[2] - 1) // 2


def pyramid_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """conv2d(x, weight, pad (s, 1)) + bias."""
    return F.conv2d(x, weight, bias, padding=(_stride_of(weight), 1))


def batch_norm_eval(x: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """``norm`` in eval mode: its running statistics, as
    ``nn.BatchNorm2d.forward`` calls ``F.batch_norm`` there."""
    return F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight,
                        norm.bias, False, 0.0, norm.eps)


def pyramid_stage_eval_plain(x: torch.Tensor, conv: nn.Conv2d,
                             norm: nn.BatchNorm2d, s: int) -> torch.Tensor:
    """conv -> batch norm (running statistics) -> ReLU -> max-pool by s."""
    y = batch_norm_eval(pyramid_conv_plain(x, conv.weight, conv.bias), norm)
    return strided_max(F.relu(y), s, axis=2)


# ---------------------------------------------------------------------------
# The kernel's tile
# ---------------------------------------------------------------------------

class ConvPlan(NamedTuple):
    """A CTA's tile: ``cog`` groups of 8 output channels x ``rg`` groups
    of s rows x ``cg`` groups of ``cols(s)`` frames (cog rg cg = 256
    threads), summed over ``chunk`` input channels a shared-memory stage."""
    cog: int
    rg: int
    cg: int
    chunk: int


def cols(s: int) -> int:
    """Frames a thread owns (pyramid_conv.cu's ``Shape<S>::C``)."""
    return 2 if s == 3 else 8 // s


def stage_floats(s: int, cog: int, rg: int, cg: int, chunk: int) -> int:
    """One shared-memory stage (``stage_floats`` in pyramid_conv.cu)."""
    w = chunk * 3 * (2 * s + 1) * CO_THREAD * cog
    x = chunk * (rg * s + 2 * s) * (cg * cols(s) + 2)
    return (w + x + 3) & ~3


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan_conv(batch: int, cin: int, cout: int, rows: int, t: int,
              s: int) -> ConvPlan:
    """The tile for ``rows`` conv rows of (batch, cin, ., t) -> cout
    channels at stride ``s``.

    The rule: the least work over the grid, CTAs times each CTA's issue
    slots: its FFMAs (the same for every tile: 256 threads of 8 x 8
    outputs) plus ``LOAD_COST`` a float it copies into shared memory (a
    thread's share), an input channel at a time, so that tiles fit the
    shape's ragged edges (rows of F, frames of T, output channels) and
    copy little; among equal costs, the plan with more CTAs. The chunk is
    the largest power of two up to 8 input channels whose two stages fit
    ``STAGES_BYTES``. One algorithm for every shape: layer 1 (Cin = 1) and
    the compute-bound layers differ only in the tile this picks."""
    fma = 3 * (2 * s + 1) * CO_THREAD * s * cols(s)
    best, best_key = None, None
    for p in candidate_plans(cin, cout, s):
        ctas = (batch * _ceil(rows, p.rg * s) * _ceil(t, p.cg * cols(s))
                * _ceil(cout, CO_THREAD * p.cog))
        per_ci = fma + LOAD_COST * stage_floats(s, p.cog, p.rg, p.cg, 1) \
            / THREADS
        key = (ctas * _ceil(cin, p.chunk) * p.chunk * per_ci, -ctas)
        if best_key is None or key < best_key:
            best, best_key = p, key
    return best


def candidate_plans(cin: int, cout: int, s: int) -> List[ConvPlan]:
    """Every tile ``plan_conv`` weighs: power-of-two groups of 256
    threads, no channel tile twice the channels or wider, each with its
    largest chunk."""
    out = []
    for cog in (1, 2, 4, 8, 16, 32):
        if cog > 1 and CO_THREAD * cog // 2 >= cout:
            break
        groups = THREADS // cog
        for cg in (4, 8, 16, 32, 64):
            if groups % cg:
                continue
            rg = groups // cg
            chunk = MAX_CHUNK
            while chunk > 1 and (chunk > cin or 8 * stage_floats(
                    s, cog, rg, cg, chunk) > STAGES_BYTES):
                chunk //= 2
            if 8 * stage_floats(s, cog, rg, cg, chunk) <= STAGES_BYTES:
                out.append(ConvPlan(cog, rg, cg, chunk))
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def check_conv_args(name: str, x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> int:
    """What the kernels take, from shapes, dtypes and strides alone (so it
    runs on CPU tensors too): fp32 contiguous x (B, Cin, F, T), weight
    (Cout, Cin, 2s + 1, 3) with s in 1..4, bias (Cout). Returns s."""
    for key, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if x.ndim != 4 or weight.ndim != 4 or bias.ndim != 1:
        raise ValueError(f"{name}: x (B, Cin, F, T), weight (Cout, Cin, KH, "
                         f"3) and bias (Cout) expected, got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    cout, cin, kh, kw = weight.shape
    s = _stride_of(weight)
    if kw != 3 or kh != 2 * s + 1 or not 1 <= s <= MAX_S:
        raise ValueError(f"{name}: the kernel takes (2s + 1, 3) kernels with "
                         f"s in 1..{MAX_S}, got ({kh}, {kw})")
    if x.shape[1] != cin or bias.shape[0] != cout:
        raise ValueError(f"{name}: x has {x.shape[1]} channels and bias "
                         f"{bias.shape[0]}, the weight ({cout}, {cin}, ...)")
    if x.shape[0] > MAX_GRID or _ceil(cout, CO_THREAD) > MAX_GRID:
        raise ValueError(f"{name}: B and Cout / 8 must be <= {MAX_GRID}, got "
                         f"{tuple(x.shape)} and {cout} channels")
    return s


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _plan(x: torch.Tensor, cout: int, rows: int, s: int) -> ConvPlan:
    b, cin, _, t = x.shape
    return plan_conv(b, cin, cout, rows, t, s)


def _taps_last(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, KH, 3) -> (Cin, KH, 3, Cout): a tap's output channels
    contiguous, as the kernel copies them."""
    return weight.permute(1, 2, 3, 0).contiguous()


def pyramid_conv_cuda(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """P1: conv2d(x, weight, pad (s, 1)) + bias on the card, with
    ``plan_conv``'s tile (every tile sums each output in the same order,
    so the bits do not depend on it or on the batch)."""
    check_kernel_inputs("pyramid_conv", x=x, weight=weight, bias=bias)
    s = check_conv_args("pyramid_conv", x, weight, bias)
    b, cin, f, t = x.shape
    cout = weight.shape[0]
    y = x.new_empty((b, cout, f, t))
    if y.numel():
        p = _plan(x, cout, f, s)
        wt = _taps_last(weight)
        PYRAMID_CONV.launch(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                            y.data_ptr(), b, cin, cout, f, t, s, p.cog, p.rg,
                            p.cg, p.chunk, x.device.index, _stream(x),
                            shapes=(tuple(x.shape), tuple(weight.shape)))
    return y


def _check_norm(name: str, norm: nn.BatchNorm2d, cout: int) -> None:
    if norm.running_mean is None or norm.weight is None:
        raise ValueError(f"{name}: the batch norm needs running statistics "
                         f"and an affine transform")
    for key in ("running_mean", "running_var", "weight", "bias"):
        t = getattr(norm, key)
        if t.shape != (cout,):
            raise ValueError(f"{name}: norm.{key} must be ({cout},), got "
                             f"{tuple(t.shape)}")


def pyramid_stage_eval_cuda(x: torch.Tensor, conv: nn.Conv2d,
                            norm: nn.BatchNorm2d, s: int) -> torch.Tensor:
    """P1's eval entry: the stage in one kernel, (B, Cout, F // s, T)."""
    name = "pyramid_conv_eval"
    _check_norm(name, norm, conv.out_channels)
    check_kernel_inputs(name, x=x, weight=conv.weight, bias=conv.bias,
                        mean=norm.running_mean, var=norm.running_var,
                        gamma=norm.weight, beta=norm.bias)
    if check_conv_args(name, x, conv.weight, conv.bias) != s:
        raise ValueError(f"{name}: a ({2 * s + 1}, 3) kernel pools by {s}, "
                         f"got {tuple(conv.weight.shape[2:])}")
    b, cin, f, t = x.shape
    cout = conv.out_channels
    y = x.new_empty((b, cout, f // s, t))
    if y.numel():
        p = _plan(x, cout, (f // s) * s, s)
        wt = _taps_last(conv.weight)
        PYRAMID_CONV_EVAL.launch(
            x.data_ptr(), wt.data_ptr(), conv.bias.data_ptr(),
            norm.running_mean.data_ptr(), norm.running_var.data_ptr(),
            norm.weight.data_ptr(), norm.bias.data_ptr(), float(norm.eps),
            y.data_ptr(), b, cin, cout, f, t, s, p.cog, p.rg, p.cg, p.chunk,
            x.device.index, _stream(x),
            shapes=(tuple(x.shape), tuple(conv.weight.shape)))
    return y


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

class _PyramidConv(torch.autograd.Function):
    """P1's forward; the backward is the one ``F.conv2d``'s autograd runs
    (``aten.convolution_backward``: cuDNN's dgrad and wgrad and the bias
    sum on the card)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return pyramid_conv_cuda(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        s = _stride_of(weight)
        return torch.ops.aten.convolution_backward(
            g, x, weight, [weight.shape[0]], [1, 1], [s, 1], [1, 1], False,
            [0, 0], 1, list(ctx.needs_input_grad))


def pyramid_conv(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """conv2d(x, weight, pad (s, 1)) + bias, s = (KH - 1) / 2: P1 for a
    CUDA tensor (differentiable), ``F.conv2d`` for a CPU one."""
    if not x.is_cuda:
        return pyramid_conv_plain(x, weight, bias)
    return _PyramidConv.apply(x, weight, bias)


def pyramid_stage_eval(x: torch.Tensor, conv: nn.Conv2d,
                       norm: nn.BatchNorm2d, s: int) -> torch.Tensor:
    """The stage in eval mode, no gradient: P1's eval entry for a CUDA
    tensor, the plain chain for a CPU one."""
    if not x.is_cuda:
        return pyramid_stage_eval_plain(x, conv, norm, s)
    return pyramid_stage_eval_cuda(x, conv, norm, s)

