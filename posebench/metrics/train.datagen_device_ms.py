"""Device ms of the on-card generator's draw of one batch
(`DeviceSynthetic.sample_batch`, called eagerly), its device events
summed over a call."""

from posebench.tracing import busy_per_iter_ms


def read(trace):
    return busy_per_iter_ms(trace.get("datagen"))
