"""A count from the device trace (its kernels) a traced step."""


def read(record, key: str = "kernels"):
    if not record.get("trace_steps") or not record.get(key):
        return None
    return record[key] / record["trace_steps"]
