"""One reader a metric: ``<name>.py`` defines ``read(run) -> float | None``,
where ``run`` is a ``harness.Run``. A reader that finds nothing to read
returns None and the metric is left out of the result line. ``_common``
holds the formulas the readers share."""
