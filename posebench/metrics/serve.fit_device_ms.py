"""Device ms of the pose fit: `fit_frame_batch` called eagerly on the
forward's outputs with the window's draws, its device events summed
over a call."""

from posebench.tracing import busy_per_iter_ms


def read(trace):
    return busy_per_iter_ms(trace.get("fit"))
