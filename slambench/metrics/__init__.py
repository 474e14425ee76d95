"""Per-layer metrics: ``<name>.py`` holds ``read(record)`` for the metric of
that name in BENCHMARK.json.  ``record`` is the traced period's: ``trace``
(``slambench/frozen/trace.load``), ``k4_calls`` (the inputs
of the first K4 launches, ``harness.KernelRecorder``), ``track_iters``
and ``map_iters``.  A reader that finds nothing to read returns None."""
