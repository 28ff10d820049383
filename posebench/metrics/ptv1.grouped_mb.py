"""MB a cloud of the (n, k, ·) neighbour tensors the Point Transformer
forward materialises: the backbone's `grouped_bytes` counter over the
batch, read after the traced run's calls."""


def read(trace):
    if trace.get("grouped_bytes") is None:
        return None
    return trace["grouped_bytes"] / trace["batch"] / 1e6
