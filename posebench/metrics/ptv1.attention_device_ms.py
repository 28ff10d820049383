"""Device ms of the Point Transformer's attention layers in a replayed
served call: the sum of the stages whose marks end in ".attn"
(`models/point_transformer.py`), read by `PosePredictor.stage_ms()`
after each of the traced run's replayed calls; the median over them."""

import statistics


def read(trace):
    sums = [sum(v for k, v in stages.items() if k.endswith(".attn"))
            for stages in trace.get("stage_ms") or []]
    sums = [s for s in sums if s > 0]
    return statistics.median(sums) if sums else None
