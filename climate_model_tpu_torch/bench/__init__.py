"""Benchmark and profiling harnesses of the port (``bench`` and ``profile``
on the card): throughput, micro, profile, stability, budget, scaling, the
roofline of the card and the op count."""
