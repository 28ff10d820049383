"""Device ms of Point Transformer V3's sparse convolution in a served
call: the device time of the kernels launched inside the spans whose
names end in ".cpe" (each block's xCPE) or ".nbr" (each level's
neighbour map) and inside "ptv3.stem" (the stem's map and
convolution), one profiled call at a time; the median over
`trace_calls` calls."""

import statistics


def read(trace):
    sums = [sum(v for k, v in spans.items()
                if k.endswith((".cpe", ".nbr")) or k == "ptv3.stem")
            for spans in trace.get("ptv3_span_ms") or []]
    sums = [s for s in sums if s > 0]
    return statistics.median(sums) if sums else None
