"""A percentile of every sample of the window (``statistics.quantiles``,
exclusive method)."""

import statistics


def read(record, key: str = "latencies_ms", q: int = 95):
    values = record.get(key) or []
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[q - 1]
