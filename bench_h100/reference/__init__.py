"""Plain reference of what the benchmarked entries compute: numpy and torch only."""
