"""NumPy helpers of the host data feed."""
