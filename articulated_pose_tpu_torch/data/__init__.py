"""Host data feed: the synthetic generator, labels, batching, prefetch."""
