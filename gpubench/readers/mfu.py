"""The model FLOPs of the profiled steps (the configuration's count,
``counts/<flops>.py``, ``counts/flops.py`` unless its file names another:
``spec.Parts``) over the device's busy seconds in them (the union of its
operations' intervals, from the ``torch.profiler`` trace), as a share of
the card's float32 peak outside the tensor cores (TF32 is off), in %: how
much of the peak the device reaches while it works. Host gaps stay out;
``idle_share`` reads them."""

from gpubench.counts import PEAKS
from gpubench.harness import spec

COUNT = {"train": "train_step", "resynth": "resynthesis"}


def read(record, peak: str = "fp32_flops_per_s"):
    tr = record.get("traffic")
    n = record.get("trace_steps")
    if tr is None or not n or not record.get("busy_s"):
        return None
    count = spec.module("counts", spec.parts(record["config"]).flops)
    t = int(round(tr["seconds"] * tr["sample_rate"]))
    work = getattr(count, COUNT[tr["kind"]])(record["config"], tr["batch"],
                                             t) * n
    return 100.0 * work / record["busy_s"] / PEAKS[peak]
