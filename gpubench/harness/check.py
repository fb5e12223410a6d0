"""How ``correct`` is decided: what the timed path produced, against the
plain reference (``gpubench/reference``), number by number against the
cell's limits (``gpubench/limits/<cell>.json``).

Training (the first steps that set-up drove through the window's own
step): the first step's loss, and the worst leaf's gaps of the first
gradient's norm as the optimizer took it and of the norm of its change
over the steps. A leaf's gap is the distance between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of both (a conv's
bias in front of a train-mode batch norm: the reference's gradient is an
exact zero, the program's rounding noise, which Adam's normalised steps
turn into moves of full size).

Resynthesis: every sampled batch's outputs row by row, each under the name
the reference gives it (GOLF: the audio, ``out_l2``, and the encoder's
output on the same call, ``head_gap``: the audio's glottal pulses carry
the float32 phase's rounding times the wavetable's steep slope, which
leaves TF32's error there under three times the program's).

The reference is the configuration's module (``spec.reference``), the
same interface for every task (``gpubench/README.md``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from . import inputs, spec


def _gap(prog: Dict[str, float], refs: Dict[str, float],
         names: List[str], median: bool = False) -> float:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's: the worst leaf's, or with ``median`` the median
    leaf's (a diagnostic)."""
    med = statistics.median(refs[n] for n in names)
    gaps = [abs(prog[n] - refs[n]) / max(refs[n], med, 1e-30)
            for n in names]
    return statistics.median(gaps) if median else max(gaps)


def train_numbers(prog: Dict, refs: Dict) -> Dict[str, float]:
    """``loss_gap``: the first step's loss (the later steps' losses follow
    Adam's first update, whose unit steps on elements of gradient near
    zero take either sign by rounding); over the leaves the reference's
    gradient moves, the worst leaf's gap of the first gradient's norm
    (``grad_gap``) and of the change's norm (``change_gap``)."""
    names = sorted(refs["grad"])
    if sorted(prog["grad"]) != names:
        raise RuntimeError("the program's leaves differ from the "
                           "reference's")
    moved = moved_leaves(refs)
    return {"loss_gap": abs(prog["loss"][0] - refs["loss"][0])
            / abs(refs["loss"][0]),
            "grad_gap": _gap(prog["grad"], refs["grad"], moved),
            "change_gap": _gap(prog["change"], refs["change"], moved)}


def moved_leaves(refs: Dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    names = sorted(refs["grad"])
    med = statistics.median(refs["grad"][n] for n in names)
    return [n for n in names if refs["grad"][n] >= 1e-3 * med]


def train_diagnostics(prog: Dict, refs: Dict) -> Dict[str, float]:
    """What the numbers compared leave out: every step's loss, the median
    leaf's gradient, and the gradient of every leaf."""
    return {"loss_gap_steps": max(abs(a - b) / abs(b) for a, b in
                                  zip(prog["loss"], refs["loss"])),
            "grad_gap_median": _gap(prog["grad"], refs["grad"],
                                    moved_leaves(refs), median=True),
            "grad_gap_all": _gap(prog["grad"], refs["grad"],
                                 sorted(refs["grad"]))}


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's L2 error over its L2 norm (rows: dim 0)."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.float().flatten(1), want.float().flatten(1)
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1).clamp_min(1e-30))
                 .max())


def dropout_seeds(seed: int, n: int) -> List[int]:
    return [inputs.stream_seed(seed, "dropout", k) for k in range(n)]


def reference_train(cell, weights, batches, seed: int, device,
                    tf32: bool = False, rows=None) -> Dict:
    return spec.reference(cell.config).train_readings(
        cell.config, weights, batches,
        dropout_seeds(seed, cell.traffic["first"]), device, rows=rows,
        tf32=tf32)


def reference_outputs(cell, weights, batches, picks: Dict, device,
                      tf32: bool = False) -> Dict:
    """The reference's outputs (the audio, then what ``KEEP`` names) for
    each kept batch index."""
    wanted = {i: batches[i] for i in sorted({v[0] for v in picks.values()})}
    return spec.reference(cell.config).outputs(
        cell.config, weights, batches[0], wanted, device, tf32=tf32)


def resynth_numbers(picks: Dict, refs: Dict, names) -> Dict[str, float]:
    """``picks``: (batch index, audio, *kept) of each kept batch; ``refs``:
    the reference's outputs by batch index; ``names``: the reference's
    ``NUMBERS``, one an output. Each output's worst ``row_gap`` over the
    kept batches. Raises where the names, the program's outputs and the
    reference's differ in number: a name left without an output would
    read 0 and pass any limit."""
    out = dict.fromkeys(names, 0.0)
    for i, *got in picks.values():
        if not len(names) == len(got) == len(refs[i]):
            raise RuntimeError(
                f"{len(names)} numbers ({', '.join(names)}) for "
                f"{len(got)} outputs of the program and {len(refs[i])} "
                f"of the reference")
        for name, g, want in zip(names, got, refs[i]):
            out[name] = max(out[name], row_gap(g, want))
    return out


def judge(numbers: Dict[str, float], limits: Dict) -> bool:
    return all(numbers[k] <= limits[k]["limit"] for k in limits)


def lines(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each number compared beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]}
            for k in limits}
