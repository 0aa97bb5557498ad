"""Device milliseconds a layer CURed spends on its experts: the busy
device time (the profiler's kernel, copy and set intervals, merged) of
the operations launched while one of the program's ``cur.experts``
ranges was open, over the layers traced. None where the capture has no
such reduction (a cell of a dense model, or a program without the
range)."""
UNIT = "ms"


def read(data):
    tr = data.get("trace")
    if not tr or not data.get("traced_layers") or "expert_busy_s" not in tr:
        return None
    return 1e3 * tr["expert_busy_s"] / data["traced_layers"]
