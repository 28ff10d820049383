"""The train step's share of the card's float32 peak (67 TFLOP/s; the
port keeps TF32 off, so its float32 products run outside the tensor
cores): 3 × the forward's GEMM FLOPs a cloud (`flops.py`) times the
clouds/s of the traced window, in %."""


def read(trace):
    if "train_flops_per_cloud" not in trace:
        return None
    return (100.0 * trace["train_flops_per_cloud"] * trace["clouds_per_s"]
            / trace["peak_flops"])
