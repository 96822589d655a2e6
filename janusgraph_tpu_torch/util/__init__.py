"""Utilities of the port: the metric-instrumented store and the periodic
reporters (``util/metrics.py``), and the cluster timestamp providers
(``util/timestamps.py``)."""

from janusgraph_tpu_torch.util.metrics import (
    MetricInstrumentedStore,
    MetricManager,
    metrics,
)

__all__ = ["MetricInstrumentedStore", "MetricManager", "metrics"]
