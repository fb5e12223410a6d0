"""A number the run recorded as it is (the set-up's host-clock seconds)."""


def read(record, key: str):
    return record.get(key)
