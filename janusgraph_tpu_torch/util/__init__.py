"""Utilities of the port: the metric-instrumented store and the periodic
reporters (``util/metrics.py``)."""
