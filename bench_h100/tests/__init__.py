"""CPU tests of the benchmark (``python -m pytest bench_h100/tests -q``)."""
