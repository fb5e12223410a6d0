"""One run of one cell: set-up, the window, the reference, the metrics.

The window's program state is freed and the device's memory peak read
before the reference runs, so the reference neither sets the peak nor
counts in ``setup_s``.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, Tuple

from . import check, drivers, env, inputs, program, spec


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, least: int = 0) -> Tuple[Dict, Dict]:
    """(the record the readers read, the numbers compared by name);
    ``least``: the window's fewest steps (the tests')."""
    env.set_precision(cell.config)
    program.build_kernels(device)
    ref = spec.reference(cell.config)
    weights = inputs.draw_weights(ref.param_spec(cell.config), seed, device)
    batches = inputs.pool(cell.traffic, seed, device,
                          spec.parts(cell.config).fields)
    kind = cell.traffic["kind"]
    rec = drivers.DRIVERS[kind](cell, seed, seconds, traced, device,
                                t_start, weights, batches, least)
    gc.collect()                 # the program's state, before the reference
    if kind == "train":
        refs = check.reference_train(cell, weights, batches, seed, device)
        numbers = check.train_numbers(rec["readings"], refs)
    else:
        refs = check.reference_outputs(cell, weights, batches,
                                       rec["outputs"], device)
        numbers = check.resynth_numbers(rec["outputs"], refs, ref.NUMBERS)
        want = tuple(next(iter(refs.values()))[0].shape)
        rec["failed"] = sum(1 for ok, shape in zip(rec["finite"],
                                                   rec["shapes"])
                            if not ok or shape != want)
    rec.update(config=cell.config, traffic=cell.traffic)
    return rec, numbers


def result(cell, rec: Dict, numbers: Dict, traced: bool, card: Dict
           ) -> Dict:
    """The run's result line: correct, counts, the cell's metrics (its
    per-layer ones when traced), the device, and last the numbers compared
    beside their limits."""
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.read(rec)
        if value is not None and math.isfinite(value):
            metrics[m.name] = {"value": value, "unit": m.unit}
    device = {"platform": "gpu", "kind": card["kind"], "count": cell.chips,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": check.judge(numbers, cell.limits)
           and rec["failed"] == 0,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["trace_window_s"]
        out["breakdown"] = {"device_ops": rec["device_ops"],
                            "idle_gaps": rec["idle_gaps"]}
    out["power_limit_w"] = card["power_limit_w"]
    out["compared"] = check.lines(numbers, cell.limits)
    return out
