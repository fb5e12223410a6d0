"""The device time of layer spans (CUDA events around the calls into the
layer, forward and backward) a traced step, in ms."""


def read(record, spans):
    have = record.get("spans") or {}
    if not record.get("trace_steps") or any(s not in have for s in spans):
        return None
    return sum(have[s] for s in spans) / record["trace_steps"]
