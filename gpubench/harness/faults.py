"""Faults of the training step's backward, planted in the program by
swapping the route table its autograd functions read (``CUDA_OPS`` on the
card, ``PLAIN_OPS`` on the CPU). Each ``plant(cuda)`` returns (an object,
its attribute, the faulty value); ``planted`` sets it for the duration of
a ``with``. ``gpubench/control.py`` reads each that a configuration's
cells can have (``chosen``) at the cells' size on the card; the tests keep
the ones the check catches. A configuration of another task names its own
faults, plants of this form in a file of its own under
``gpubench/faults/``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

from golf_tpu_torch.ops import allpole as ap
from golf_tpu_torch.ops import lookup as lk

from . import spec


def _chunked(fn, chunk: int):
    """``fn(g, a)`` on time chunks of ``chunk`` samples, each from a zero
    state: a scan that drops the state it carries between chunks."""
    def run(g, a):
        return torch.cat([fn(g[:, s:s + chunk].contiguous(),
                             a[:, s:s + chunk].contiguous())
                          for s in range(0, g.shape[1], chunk)], 1)
    return run


def _halves(fn):
    """``fn(x, a)`` on each half of a row from a zero state (``a`` per
    row)."""
    def run(x, a):
        h = x.shape[1] // 2
        return torch.cat([fn(x[:, :h].contiguous(), a),
                          fn(x[:, h:].contiguous(), a)], 1)
    return run


def b4_adjoint_chunks(cuda: bool = True):
    """B4's adjoint drops its state at the kernel's chunk boundaries."""
    route = ap.CUDA_OPS if cuda else ap.PLAIN_OPS
    chunk = ap.chunk_for(64, 47760)
    return ap, "CUDA_OPS" if cuda else "PLAIN_OPS", ap.AllpoleOps(
        route.fwd, _chunked(route.adj, chunk))


def b2_adjoint_halves(cuda: bool = True):
    """B2's adjoint walks each half of a window from a zero state."""
    route = ap.CONST_CUDA_OPS if cuda else ap.CONST_PLAIN_OPS
    fwd = _halves(route.fwd)

    def adj(g, y, a, with_da=True):
        return ap._const_adjoint_composite(fwd, g, y, a, with_da)
    return ap, "CONST_CUDA_OPS" if cuda else "CONST_PLAIN_OPS", \
        ap.ConstOps(route.fwd, adj)


def b3b_half_blocks(cuda: bool = True):
    """B3b's table cotangent with every other block's share left out."""
    route = lk.CUDA_OPS if cuda else lk.PLAIN_OPS

    def dtab(ph, g, hop, frames, s):
        g = g.clone()
        g[:, 1::2] = 0
        return route.dtab(ph, g, hop, frames, s)
    return lk, "CUDA_OPS" if cuda else "PLAIN_OPS", lk.LookupOps(
        route.fwd, route.res, dtab)


# the faults of the backward that each end filter's cell can have
BY_END_FILTER = {"allpole": (b4_adjoint_chunks, b3b_half_blocks),
                 "allpole_const": (b2_adjoint_halves, b3b_half_blocks)}


def end_filter(config) -> str:
    """``allpole`` (the sample-wise filter, B4) or ``allpole_const`` (the
    frame-wise one, B2): the end filter the configuration's decoder
    runs."""
    path = config["model"]["decoder"]["init_args"]["end_filter"][
        "class_path"]
    return "allpole" if path.endswith("LTVMinimumPhaseFilterPrecise") \
        else "allpole_const"


def chosen(config: Dict) -> List[Callable]:
    """The faults of the configuration's cells: those its ``faults`` names
    (``<module>.<function>`` of ``gpubench/faults/<module>.py``), or
    without the key those of its end filter."""
    names = spec.parts(config).faults
    if names is None:
        return list(BY_END_FILTER[end_filter(config)])
    return [getattr(spec.module("faults", mod), fn)
            for mod, _, fn in (name.rpartition(".") for name in names)]


@contextlib.contextmanager
def planted(plant, cuda: bool):
    """The program with the fault ``plant`` in its route on the card
    (``cuda``) or the CPU."""
    module, attr, faulty = plant(cuda)
    orig = getattr(module, attr)
    setattr(module, attr, faulty)
    try:
        yield
    finally:
        setattr(module, attr, orig)
