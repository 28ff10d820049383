"""The card's idle share over the replayed served calls: 1 − the union
of the device intervals over the window between the trace's marks, in
%."""


def read(trace):
    if trace.get("kind") != "serve":
        return None
    w = trace["window"]
    return 100.0 * (1.0 - w["busy_us"] / w["window_us"])
