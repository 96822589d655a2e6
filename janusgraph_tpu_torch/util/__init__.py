"""Utilities of the port: the metric-instrumented store and the periodic
reporters (``util/metrics.py``), and the cluster timestamp providers
(``util/timestamps.py``)."""
