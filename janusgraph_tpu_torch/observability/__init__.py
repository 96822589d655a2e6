"""Observability of the port: the device peak table so far
(``profiler.device_peaks``); telemetry spans, the cost harvest and the
flight recorder are not ported yet."""
