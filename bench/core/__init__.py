"""The harness: what every cell shares (spec loading, traffic, the window,
weights, the trace, the check).  Cells, configurations, traffic mixes and
per-layer metrics are data files and small readers found by name."""
