#!/usr/bin/env python3
"""B1 and B3a (``kernels/csrc/lookup.cu``) over the split of their grid.

    python tools/lookup_split_sweep.py

At the three shapes the main path gives B1 (a streaming push (4, 3, 9600),
serving 4 x 6 s (4, 60, 9600), training 64 x 2 s (64, 20, 9600), tables of
2048 columns) and at the training shape for B3a: each kernel with the
split ``ops.lookup.plan_split`` chooses and with others (``splits`` CTAs a
block, pieces of whole 16-byte units), each held against its plain
version (B1 within 2e-6, B3a's residuals bit for bit) and timed with
``chip_smoke.cuda_ms``; beside them the bound, ``F.grid_sample`` on the
same lookup and the floor of a back-to-back launch (a one-element
``zero_()``, timed the same way). The planned split is timed first and
last, for the spread.

Beside them, B1 and B3a before the split (one CTA a block,
``tools/lookup_unsplit.cu``) are timed at the same shapes in turns with the
planned split (old, new, new, old).

Prints the card's name and power limit first and writes everything to
``chiprun_out/lookup_split_sweep.json``. Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from golf_tpu_torch import kernels  # noqa: E402
from golf_tpu_torch.ops import lookup as lk  # noqa: E402

SHAPES = {
    "push": chip_smoke.stream_shapes(chip_smoke.BATCH),
    "serve": chip_smoke.main_path_shapes(chip_smoke.BATCH,
                                         int(chip_smoke.SECONDS
                                             * chip_smoke.SR)),
    "train": chip_smoke.main_path_shapes(chip_smoke.TRAIN_BATCH,
                                         int(chip_smoke.TRAIN_SECONDS
                                             * chip_smoke.SR)),
}
SPLITS = {"push": (1, 2, 4, 6, 8, 12, 16, 24, 33, 48),
          "serve": (1, 2, 3, 4, 6, 8, 12, 16, 24),
          "train": (1, 2, 3, 4, 6, 8, 12)}
RES_SPLITS = (1, 2, 3, 4, 6, 8)
REPS = {"push": 200, "serve": 100, "train": 30}


def split(hop: int, want: int) -> lk.LookupPlan:
    """``want`` pieces of whole 16-byte units (fewer after rounding)."""
    unit = 4 if hop % 4 == 0 else 1
    units = -(-hop // unit)
    piece = unit * -(-units // want)
    return lk.LookupPlan(-(-hop // piece), piece)


def b1(ph, tables, hop, plan):
    """B1 with the split ``plan``, by its C entry."""
    out = torch.empty_like(ph)
    kernels.LOOKUP.launch(ph.data_ptr(), tables.data_ptr(), out.data_ptr(),
                          *ph.shape, *tables.shape[1:], plan.splits,
                          plan.piece, ph.device.index,
                          torch.cuda.current_stream().cuda_stream)
    return out


def b3a(ph, tables, hop, plan):
    """B3a with the split ``plan``: (out, d_top, d_bot)."""
    outs = [torch.empty_like(ph) for _ in range(3)]
    kernels.LOOKUP_RES.launch(ph.data_ptr(), tables.data_ptr(),
                              *(o.data_ptr() for o in outs), *ph.shape,
                              *tables.shape[1:], plan.splits, plan.piece,
                              ph.device.index,
                              torch.cuda.current_stream().cuda_stream)
    return outs


def turns(old, new, reps):
    """Old, new, new, old, each timed by ``cuda_ms``."""
    return [(w, chip_smoke.cuda_ms(old if w == "old" else new, reps))
            for w in ("old", "new", "new", "old")]


def main() -> int:
    if not torch.cuda.is_available():
        print("lookup_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.phase_environment()
    log: dict = {}
    kernels.build([kernels.LOOKUP, kernels.LOOKUP_RES, chip_smoke.UNSPLIT,
                   chip_smoke.UNSPLIT_RES], log)
    for ln in log.get("lookup.cu", "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas: {ln.strip()}")
    n_sm = lk.sm_count(0)
    z = torch.zeros(1, device="cuda")
    floor_ms = chip_smoke.cuda_ms(lambda: z.zero_(), 500)
    print(f"launch floor (one-element zero_, back to back): "
          f"{floor_ms * 1e3:.2f} us; {n_sm} SMs")
    result = {"card": card, "n_sm": n_sm, "floor_ms": floor_ms, "b1": {},
              "b3a": {}}
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for label, shapes in SHAPES.items():
        ph, tables, hop = chip_smoke.lookup_inputs(gen, shapes)
        b, blocks, _ = ph.shape
        reps = REPS[label]
        plan = lk.cuda_plan(ph, tables)
        ref = lk.lookup_blocks_plain(ph, tables, hop)
        n_el = ph.numel()
        bnd = chip_smoke.bound(4 * (2 * n_el + tables.numel()), 15 * n_el)
        padded, grid = chip_smoke.grid_sample_operands(ph, tables, hop)
        lib_ms = chip_smoke.cuda_ms(
            lambda: chip_smoke.grid_sample_lookup(padded, grid), reps)
        del padded, grid

        def time_plan(p):
            err = (b1(ph, tables, hop, p) - ref).abs().max().item()
            assert err <= 2e-6, (label, p, err)
            return chip_smoke.cuda_ms(lambda: b1(ph, tables, hop, p),
                                      reps), err

        rows = [dict(splits=plan.splits, piece=plan.piece, planned=True,
                     ctas=b * blocks * plan.splits,
                     **dict(zip(("ms", "err"), time_plan(plan))))]
        for want in SPLITS[label]:
            p = split(hop, want)
            if p == plan or any(r["splits"] == p.splits for r in rows):
                continue
            rows.append(dict(splits=p.splits, piece=p.piece,
                             ctas=b * blocks * p.splits,
                             **dict(zip(("ms", "err"), time_plan(p)))))
        rows.append(dict(splits=plan.splits, piece=plan.piece, planned=True,
                         ctas=b * blocks * plan.splits,
                         **dict(zip(("ms", "err"), time_plan(plan)))))
        entry = {"shape": [list(ph.shape), list(tables.shape)],
                 "bound_ms": bnd[0], "library_ms": lib_ms, "rows": rows}
        old = chip_smoke.unsplit_fwd(ph, tables, hop)
        entry["baseline_err"] = (old - ref).abs().max().item()
        assert entry["baseline_err"] <= 2e-6, (label, "before the split")
        entry["turns"] = turns(
            lambda: chip_smoke.unsplit_fwd(ph, tables, hop),
            lambda: lk.lookup_blocks_cuda(ph, tables, hop), reps)
        result["b1"][label] = entry
        print(f"B1 {label} {tuple(ph.shape)} x {tuple(tables.shape)}: bound "
              f"{bnd[0] * 1e3:.2f} us, grid_sample {lib_ms * 1e3:.2f} us, "
              f"floor {floor_ms * 1e3:.2f} us")
        for r in rows:
            print(f"  splits {r['splits']:4d} piece {r['piece']:5d} CTAs "
                  f"{r['ctas']:6d}: {r['ms'] * 1e3:8.2f} us, err "
                  f"{r['err']:.1e}{'  (planned)' if r.get('planned') else ''}")
        print("  turns (before the split / this one): " + ", ".join(
            f"{w} {t * 1e3:.2f}" for w, t in entry["turns"]))
        if label == "train":
            refs = lk.lookup_res_plain(ph, tables, hop)
            bnd = chip_smoke.bound(4 * (4 * n_el + tables.numel()),
                                   17 * n_el)

            def time_res(p):
                outs = b3a(ph, tables, hop, p)
                assert (outs[0] - refs[0]).abs().max().item() <= 2e-6
                assert torch.equal(outs[1], refs[1]) and \
                    torch.equal(outs[2], refs[2]), (p, "residuals")
                return chip_smoke.cuda_ms(lambda: b3a(ph, tables, hop, p),
                                          reps)

            rows = [dict(splits=plan.splits, piece=plan.piece, planned=True,
                         ms=time_res(plan))]
            for want in RES_SPLITS:
                p = split(hop, want)
                if p != plan:
                    rows.append(dict(splits=p.splits, piece=p.piece,
                                     ms=time_res(p)))
            rows.append(dict(splits=plan.splits, piece=plan.piece,
                             planned=True, ms=time_res(plan)))
            res_entry = {"shape": [list(ph.shape), list(tables.shape)],
                         "bound_ms": bnd[0], "rows": rows}
            res_entry["turns"] = turns(
                lambda: chip_smoke.unsplit_res(ph, tables, hop),
                lambda: lk.lookup_res_cuda(ph, tables, hop), reps)
            result["b3a"][label] = res_entry
            print(f"B3a {label}: bound {bnd[0] * 1e3:.2f} us")
            for r in rows:
                print(f"  splits {r['splits']:4d} piece {r['piece']:5d}: "
                      f"{r['ms'] * 1e3:8.2f} us"
                      f"{'  (planned)' if r.get('planned') else ''}")
            print("  turns (before the split / this one): " + ", ".join(
                f"{w} {t * 1e3:.2f}" for w, t in res_entry["turns"]))
        del ph, tables, ref
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "lookup_split_sweep.json").write_text(json.dumps(result,
                                                            indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
