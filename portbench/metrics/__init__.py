"""One reader a per-layer metric, ``<metric name>.py``, each with ``read(run)
-> float | None`` (``None``: nothing to read; the metric is left out of
the result). ``run`` is a ``portbench.readers.RunRecord``."""
