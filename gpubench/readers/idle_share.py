"""The share of a step in which no operation ran on the device, in %: one
less the device's busy time a profiled step (the union of its operations'
intervals) over the host time a step of the untraced window. The
profiler's own host cost, which slows its steps, stays out; the run's
``device`` line has the profiled window's busy and host seconds too."""


def read(record):
    n = record.get("trace_steps")
    if not n or "busy_s" not in record or not record.get("attempted"):
        return None
    step = record["window_s"] / record["attempted"]
    return 100.0 * (1.0 - record["busy_s"] / n / step)
