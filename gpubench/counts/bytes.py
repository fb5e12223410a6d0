"""The least bytes of each CUDA kernel's operation, from the operand shapes
its launch records (``CudaKernel.launch(..., shapes=...)``): every input
byte read once and every output byte written once, float32, whatever the
kernel reads again.

* lookup (B1): ph (B, blocks, hop) and tables (B, rows, S) in, the output
  (B, blocks, hop) out.
* lookup_res (B3a): as B1, with the two corner differences out.
* lookup_dtab (B3b): ph and the cotangent g (B, blocks, hop) in, the table
  cotangent (B, rows, S) out (its shape is the launch's second).
* allpole_tv (B4) and its adjoint entry: x or g (B, T) and a (B, T, p) in,
  y or dx (B, T) out.
* allpole_const (B2): x (N, T) and a (N, p) in, y (N, T) out.
* allpole_const_adjoint: g and y (N, T) and a (N, p) in, dx (N, T) and
  da (N, p) out (the training path's form, which forms da).
"""

from __future__ import annotations

import math
from typing import Sequence

F32 = 4


def _n(shape) -> int:
    return math.prod(shape)


def lookup(shapes: Sequence) -> int:
    ph, tables = shapes
    return F32 * (2 * _n(ph) + _n(tables))


def lookup_res(shapes: Sequence) -> int:
    ph, tables = shapes
    return F32 * (4 * _n(ph) + _n(tables))


def lookup_dtab(shapes: Sequence) -> int:
    ph, dtab = shapes
    return F32 * (2 * _n(ph) + _n(dtab))


def allpole_tv(shapes: Sequence) -> int:
    x, a = shapes
    return F32 * (2 * _n(x) + _n(a))


def allpole_const(shapes: Sequence) -> int:
    x, a = shapes
    return F32 * (2 * _n(x) + _n(a))


def allpole_const_adjoint(shapes: Sequence) -> int:
    g, a = shapes
    return F32 * (3 * _n(g) + 2 * _n(a))


BYTES = {"lookup": lookup, "lookup_res": lookup_res,
         "lookup_dtab": lookup_dtab, "allpole_tv": allpole_tv,
         "allpole_tv_adjoint": allpole_tv, "allpole_const": allpole_const,
         "allpole_const_adjoint": allpole_const_adjoint}
