"""Per-layer metrics: ``<metric>.json`` names the metric's reader
(``<reader>.py`` beside it, by default the part of the metric's name before
its first dot), its unit, the end-to-end metric it moves and the reader's
arguments. A reader is ``read(view, info, spec) -> float | None``: ``view``
the traced slice (``yardstick.trace.TraceView``), ``info`` the slice's work
and the cell's sizes (``yardstick.run.SliceInfo``), ``spec`` the JSON. It
returns None where it finds nothing to read, and the metric is then left out
of the result.
"""
