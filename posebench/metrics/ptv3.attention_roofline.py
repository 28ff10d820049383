"""Point Transformer V3's fused attention in the traced window against
its roofline: Σ the floors of the window's sequences (`work_ptv3.py`,
each the larger of 4·L²·C FLOPs at 989 TFLOP/s and its q, k, v and
output bytes at 3.35 TB/s, from the `sequences` counter of each counted
call) over Σ the device time of the events whose names hold one of
`work_ptv3.ATTN_SYMBOLS`, in %."""

from posebench.metrics.work_ptv3 import ATTN_SYMBOLS
from posebench.tracing import kernel_time_us


def read(trace):
    if "attention_floor_us" not in trace:
        return None
    spent = kernel_time_us(trace["window"], ATTN_SYMBOLS)
    if spent <= 0:
        return None
    return 100.0 * trace["attention_floor_us"] / spent
