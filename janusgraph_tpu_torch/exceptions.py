"""Exceptions of the port (the part of ``janusgraph_tpu/exceptions.py`` the
OLAP path, the storage layer, the transaction and the traversal raise).

Backend errors split into *temporary* ones, which the retry guard
(``storage/backend_op.py``) replays with backoff, and *permanent* ones,
which it lets through at once. The locking errors sit in that taxonomy:
lock contention and an expired lease are temporary, a changed expected
value is permanent."""


class JanusGraphTorchError(Exception):
    """Base class of the port's errors."""


class SuperstepPreempted(JanusGraphTorchError):
    """An OLAP superstep was preempted (injected or real). An executor with
    checkpointing on resumes from its last checkpoint."""


class BackendError(JanusGraphTorchError):
    """A storage backend failed."""


class TemporaryBackendError(BackendError):
    """A storage failure that a retry may get past (the load_csr scan
    re-issues the key range from just past its last row)."""


class PermanentBackendError(BackendError):
    """A storage failure no retry gets past."""


class TemporaryLockingError(TemporaryBackendError):
    """Lock contention or an expired lease; a retry of the transaction may
    succeed."""


class PermanentLockingError(PermanentBackendError):
    """The lock protocol failed for good (an expected value changed under
    the lock)."""


class IDPoolExhaustedError(JanusGraphTorchError):
    """An id namespace ran out of ids."""


class InvalidIDError(JanusGraphTorchError):
    """An element id that the id layout cannot hold or decode."""


class SchemaViolationError(JanusGraphTorchError):
    """A schema element is missing, clashes or is not of the expected kind."""


class ConfigurationError(JanusGraphTorchError):
    """An unknown option, a value its validator refuses, or an option the
    port does not honour yet (the message names the ROADMAP item)."""


class InvalidElementError(JanusGraphTorchError):
    """An operation on a removed element or a closed transaction."""

    def __init__(self, msg: str = "", element=None):
        super().__init__(msg)
        self.element = element


class ReadOnlyTransactionError(JanusGraphTorchError):
    """A write through a read-only transaction."""


class CircuitOpenError(PermanentBackendError):
    """A circuit breaker is open: the call failed fast without touching the
    backend. Permanent from the retry guard's point of view (replaying an
    open circuit inside one operation is pointless spin); the breaker itself
    recovers independently via its half-open probe cycle
    (``storage/circuit.py``)."""


class DeadlineExceededError(PermanentBackendError):
    """The caller's ambient deadline (``core/deadline.py``) is spent. A
    permanent error: no retry of an operation whose answer nobody waits for
    can help."""


class QueryError(JanusGraphTorchError):
    """A malformed or unsupported query."""
