#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, at the
cell's own size, in one process (the benchmark's runs do not run this):

    python3 gpubench/control.py --workload <cell> --seeds 1 2 ... \
        [--control 3] [--out chiprun_out/control]

For every seed, the program's numbers against the reference (the lower
readings). For the first ``--control`` seeds also the control's: the
reference computed with TF32 on for matmuls and cuDNN (the precision below
the configured float32) put in the program's place; and the faults the
cell can have, planted in the reference put in the program's place:
training, half of the batch left out (the mean over the rest); batch
resynthesis, an answer altered where it is produced (one row of a batch
given another row's audio). A state left unchanged by the step reads 1 in
``change_gap`` by definition and needs no run. Training also plants the
configuration's faults in the program (``harness/faults.py::chosen``; the
GOLF cells': an end filter's adjoint that drops its state between chunks,
and B3b's table cotangent with half of the blocks left out). The
reference, the inputs and the faults are the configuration's
(``harness/spec.py::Parts``). One JSON line a reading. Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def worst(got: dict, want: dict, n: int = 3) -> dict:
    """The losses, and the leaves with the largest gaps of each norm as the
    numbers compared measure them."""
    import statistics

    from gpubench.harness import check

    out = {"loss_program": got["loss"], "loss_reference": want["loss"]}
    moved = check.moved_leaves(want)
    for key in ("grad", "change"):
        med = statistics.median(want[key][k] for k in moved)
        gaps = {k: abs(got[key][k] - want[key][k]) / max(want[key][k], med)
                for k in moved}
        out[f"worst_{key}"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def program_fault_readings(cell, weights, batches, seed: int, want,
                           device) -> list:
    """The program's first steps with each backward fault planted."""
    import gc

    import torch

    from gpubench.harness import check, drivers, faults, program

    out = []
    for plant in faults.chosen(cell.config):
        with faults.planted(plant, cuda=True):
            prog = program.Training(cell.config, weights, batches[0],
                                    device)
            got = drivers.first_steps(prog, batches, seed,
                                      cell.traffic["first"], weights)
            prog.close()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        out.append((f"fault_{plant.__name__}", dict(
            check.train_numbers(got, want),
            **check.train_diagnostics(got, want))))
    return out


def readings(cell, seed: int, control: bool, device) -> list:
    import gc

    import torch

    from gpubench.harness import check, drivers, inputs, program, spec

    ref = spec.reference(cell.config)
    weights = inputs.draw_weights(ref.param_spec(cell.config), seed, device)
    batches = inputs.pool(cell.traffic, seed, device,
                          spec.parts(cell.config).fields)
    out = []
    if cell.traffic["kind"] == "train":
        prog = program.Training(cell.config, weights, batches[0], device)
        got = drivers.first_steps(prog, batches, seed, cell.traffic["first"],
                                  weights)
        prog.close()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        want = check.reference_train(cell, weights, batches, seed, device)
        out.append(("program", dict(check.train_numbers(got, want),
                                    **check.train_diagnostics(got, want),
                                    **worst(got, want))))
        if control:
            tf32 = check.reference_train(cell, weights, batches, seed,
                                         device, tf32=True)
            out.append(("control_tf32", dict(
                check.train_numbers(tf32, want),
                **check.train_diagnostics(tf32, want))))
            half = check.reference_train(cell, weights, batches, seed,
                                         device,
                                         rows=cell.traffic["batch"] // 2)
            out.append(("fault_half_batch", dict(
                check.train_numbers(half, want),
                **check.train_diagnostics(half, want))))
            out += program_fault_readings(cell, weights, batches, seed,
                                          want, device)
        return out
    prog = program.Resynthesis(cell.config, weights, batches[0], device)
    picks = {}
    for k in range(1, len(batches)):
        y = prog.predict(batches[k])
        picks[k] = (k, y, *prog.kept)
    prog.close()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    want = check.reference_outputs(cell, weights, batches, picks, device)
    out.append(("program", check.resynth_numbers(picks, want, ref.NUMBERS)))
    if control:
        tf32 = check.reference_outputs(cell, weights, batches, picks, device,
                                       tf32=True)
        out.append(("control_tf32", check.resynth_numbers(
            {k: (k, *tf32[k]) for k in tf32}, want, ref.NUMBERS)))
        altered = {}
        for k, (i, y, *kept) in picks.items():
            y = y.clone()
            y[0] = y[1]
            altered[k] = (i, y, *kept)
        out.append(("fault_altered_answer",
                    check.resynth_numbers(altered, want, ref.NUMBERS)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/control")
    args = ap.parse_args()
    import torch

    from gpubench.harness import env, program, spec

    cell = spec.load_cell(args.workload)
    env.require_cuda(cell.chips)
    env.set_precision(cell.config)
    device = torch.device("cuda", 0)
    program.build_kernels(device)
    card = env.card()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{cell.name}.jsonl")
    with open(path, "a") as f:
        for n, seed in enumerate(args.seeds):
            t = time.perf_counter()
            for side, numbers in readings(cell, seed, n < args.control,
                                          device):
                line = json.dumps({"cell": cell.name, "seed": seed,
                                   "side": side, "numbers": numbers,
                                   "card": card})
                print(line, flush=True)
                f.write(line + "\n")
            print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
                  file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
