"""Device ms of Point Transformer V3's attention in a served call: the
device time of the kernels launched inside the spans whose names end in
".attn" (`models/point_transformer_v3.py`; the LayerNorm before, the
qkv and projection Linears, the gathers and the fused attention), one
profiled call at a time; the median over `trace_calls` calls."""

import statistics


def read(trace):
    sums = [sum(v for k, v in spans.items() if k.endswith(".attn"))
            for spans in trace.get("ptv3_span_ms") or []]
    sums = [s for s in sums if s > 0]
    return statistics.median(sums) if sums else None
