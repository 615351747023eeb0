"""One reader per per-layer metric, found by the metric's name: each module
gives ``UNIT``, ``LAYER``, ``MOVES`` and ``read(summary)``, which returns
the metric from the traced slice's summary (``o3r_bench.trace``, with the
cell's shapes and the window's latencies added by the harness), or None
where the slice holds nothing to read."""
