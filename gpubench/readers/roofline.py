"""A kernel's share of its roofline, in %: the least time its operation
needs (the bytes of every launch in the traced window, from its operand
shapes, at the card's peak bandwidth) over the device time of the
operations inside its ``record_function`` ranges. Nothing where the kernel
did not run or took no device time."""

from gpubench.counts import PEAKS
from gpubench.counts.bytes import BYTES


def read(record, kernel: str):
    launches = (record.get("launches") or {}).get(kernel)
    rng = (record.get("ranges") or {}).get(kernel)
    if not launches or not rng or rng["device_s"] <= 0:
        return None
    need = sum(BYTES[kernel](s) for s in launches) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * need / rng["device_s"]
