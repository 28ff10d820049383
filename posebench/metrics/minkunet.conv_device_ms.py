"""Device ms of MinkUNet's sparse convolutions in a served call: the
device time of the kernels launched inside the convolutions' spans
(the stem's, each down's and up's, each block's `.c1`, `.c2`, `.proj`)
and the maps' (`.map`), `models/minkunet.py`, one profiled call at a
time; the median over `trace_calls` calls."""

import statistics

from posebench.metrics.work_minkunet import is_conv_span, is_map_span


def read(trace):
    sums = [sum(v for k, v in spans.items()
                if is_conv_span(k) or is_map_span(k))
            for spans in trace.get("minkunet_span_ms") or []]
    sums = [s for s in sums if s > 0]
    return statistics.median(sums) if sums else None
