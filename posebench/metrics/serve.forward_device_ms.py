"""Device ms of the ANCSH forward: the predictor's model called eagerly
on the window's batch shape, its device events summed over a call."""

from posebench.tracing import busy_per_iter_ms


def read(trace):
    return busy_per_iter_ms(trace.get("forward"))
