"""The port's FPS, ball-query and 3-NN kernels in the replayed window
against their roofline: Σ floors (each call's work from `work.py` at
67 TFLOP/s float32 and 3.35 TB/s, the first-S hits from the reference's
plain ball query on the same clouds) over Σ the device time of the
events whose names hold `work.KERNEL_SYMBOLS`, in %."""

from posebench.metrics.work import KERNEL_SYMBOLS
from posebench.tracing import kernel_time_us


def read(trace):
    if "kernel_floor_us" not in trace:
        return None
    spent = kernel_time_us(trace["window"], KERNEL_SYMBOLS)
    if spent <= 0:
        return None
    return 100.0 * trace["kernel_floor_us"] / spent
