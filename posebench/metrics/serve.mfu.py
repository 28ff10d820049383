"""The served step's share of the card's bf16 peak (989 TFLOP/s): the
forward's GEMM FLOPs, counted from the configuration's widths and N
(`flops.py`), times the clouds/s of the traced window, in %.  The
fit's arithmetic is no model FLOPs and is not counted."""


def read(trace):
    if "forward_flops_per_cloud" not in trace or "forward" not in trace:
        return None
    return (100.0 * trace["forward_flops_per_cloud"] * trace["clouds_per_s"]
            / trace["peak_flops"])
