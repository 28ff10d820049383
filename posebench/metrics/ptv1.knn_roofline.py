"""The `knn` kernel in the replayed window against its roofline: Σ the
floors of the window's searches (`work_knn.py`, each launch's larger of
pairs × 9 f32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s) over
Σ the device time of the events whose names hold `knn_kernel`, in %."""

from posebench.metrics.work_knn import KNN_SYMBOLS
from posebench.tracing import kernel_time_us


def read(trace):
    if "knn_floor_us" not in trace:
        return None
    spent = kernel_time_us(trace["window"], KNN_SYMBOLS)
    if spent <= 0:
        return None
    return 100.0 * trace["knn_floor_us"] / spent
