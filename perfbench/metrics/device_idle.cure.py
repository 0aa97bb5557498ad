"""Share of the traced sub-window in which no kernel, copy or set ran on
the device (the profiler's device intervals, merged)."""
UNIT = "%"


def read(data):
    tr = data.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
