"""Event-axis sharding over cards or processes, and the histogram reductions."""
