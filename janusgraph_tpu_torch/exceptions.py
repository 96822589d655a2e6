"""Exceptions of the port (the part of ``janusgraph_tpu/exceptions.py`` the
OLAP path, the storage layer, the transaction, the traversal and the
query server raise).

Backend errors split into *temporary* ones, which the retry guard
(``storage/backend_op.py``) replays with backoff, and *permanent* ones,
which it lets through at once. The locking errors sit in that taxonomy:
lock contention and an expired lease are temporary, a changed expected
value is permanent. The chaos engine's faults (``storage/faults.py``) sit
in it too: an injected fault is temporary, an injected crash permanent."""


class JanusGraphTorchError(Exception):
    """Base class of the port's errors."""


#: the reference's name for the base class: ``except JanusGraphTPUError``
#: catches every error of the port
JanusGraphTPUError = JanusGraphTorchError


class SuperstepPreempted(JanusGraphTorchError):
    """An OLAP superstep was preempted (injected or real). An executor with
    checkpointing on resumes from its last checkpoint."""


class ShardPreempted(SuperstepPreempted):
    """One shard of a multi-device run was preempted mid-superstep. Every
    shard rolls back to the last complete checkpoint manifest and replays
    (raised by ``FaultPlan.sharded_hook``, absorbed by the sharded
    executor's resume)."""


class CollectiveTimeout(SuperstepPreempted):
    """A cross-shard collective timed out or failed; recovered like a shard
    preemption."""


class HaloDropped(SuperstepPreempted):
    """A destination-binned halo batch was dropped in flight; recovered like
    a failed collective."""


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


class InjectedFaultError(TemporaryBackendError):
    """A fault the chaos engine injected (``storage/faults.py``). Temporary:
    the retry and recovery paths are expected to absorb it."""


class InjectedCrashError(PermanentBackendError):
    """A chaos-engine crash point: a batch torn mid-flight (some rows
    applied, some not). Permanent, so no retry guard papers over it;
    torn-commit recovery on reopen is the path under test."""


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


class ServerOverloadedError(JanusGraphTorchError):
    """The serving path refused work under overload (admission shed, or a
    brownout rung refusing OLAP submits). Carries ``retry_after_s`` when
    the refuser computed a backoff hint."""

    def __init__(self, msg, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
