"""Exceptions of the port (the part of ``janusgraph_tpu/exceptions.py`` the
OLAP path raises)."""


class JanusGraphTorchError(Exception):
    """Base class of the port's errors."""


class SuperstepPreempted(JanusGraphTorchError):
    """An OLAP superstep was preempted (injected or real). An executor with
    checkpointing on resumes from its last checkpoint."""
