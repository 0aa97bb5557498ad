"""Device milliseconds a layer CURed: the traced stretch's busy device
time (the profiler's kernel, copy and set intervals, merged) over the
layers compressed in it."""
UNIT = "ms"


def read(data):
    tr = data.get("trace")
    if not tr or not data.get("traced_layers"):
        return None
    return 1e3 * tr["busy_s"] / data["traced_layers"]
