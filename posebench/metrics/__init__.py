"""Per-layer metrics: `<metric>.py` is the reader of the metric of that
name in BENCHMARK.json, `read(trace) -> float | None`, where `trace` is
what the cell's driver recorded in its `--trace 1` run.  A reader that
finds nothing to read returns None, and the metric is left out of the
result line.  `flops.py` and `work.py` hold the arithmetic they share.
"""
