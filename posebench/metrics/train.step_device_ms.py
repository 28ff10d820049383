"""Device ms of one replayed fused train step (the generator's draw,
forward, loss, gradient, Adam): the traced window's device events
summed, over its steps."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    w = trace["window"]
    return sum(e - s for _, s, e in w["events"]) / 1e3 / trace["steps"]
