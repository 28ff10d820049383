"""MinkUNet's convolutions against their roofline: Σ the floors of the
profiled calls' convolutions (`work_minkunet.py`, each the larger of
2·pairs·C_in·C_out at 989 TFLOP/s and its rows and weights moved once
at 3.35 TB/s, from the counters of the call) over Σ the device time of
the kernels inside the convolutions' spans of the same calls (their
maps left out), in %."""

from posebench.metrics.work_minkunet import is_conv_span


def read(trace):
    floors = trace.get("minkunet_conv_floor_us")
    spans = trace.get("minkunet_span_ms")
    if not floors or not spans:
        return None
    spent_ms = sum(v for s in spans for k, v in s.items() if is_conv_span(k))
    if spent_ms <= 0:
        return None
    return 100.0 * sum(floors) / (1e3 * spent_ms)
