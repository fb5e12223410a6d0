"""An amount of the window's work over the window's host-clock seconds."""


def read(record, amount: str = "audio_s", over: str = "window_s"):
    if record.get(over, 0) <= 0 or amount not in record:
        return None
    return record[amount] / record[over]
