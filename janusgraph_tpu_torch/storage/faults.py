"""Chaos engine: seeded, deterministic fault injection at the KCVS seam —
the port's copy of ``janusgraph_tpu/storage/faults.py``, whole.

- :class:`FaultPlan` — a seeded plan of fault decisions. Every decision is
  a pure function of ``(seed, fault kind, per-kind operation index)`` (a
  CRC hash, not a shared RNG stream), so the same seed over the same
  workload reproduces the same fault sequence, and the same journal as
  the reference's plan, decision for decision. Every injected fault is
  appended to a bounded ``journal``, counted (``chaos.injected.<kind>``)
  and recorded as a ``fault`` flight event.
- :class:`FaultInjectingStoreManager` / :class:`FaultInjectingStore` —
  wrap any store manager and execute the plan on the data path. System
  stores (ids, config, logs, locks) are exempt by default: chaos targets
  the data plane, never the recovery machinery that must repair it.

Fault kinds (all off by default):

===================  =====================================================
``read`` / ``write`` probabilistic :class:`InjectedFaultError` (temporary)
                     on slice reads and mutations, absorbed by the
                     backend's retry guard (``storage/backend_op.py``)
``latency``          latency spikes on reads
``overload``         a latency storm: from read ``overload-at`` the next
                     ``overload-ops`` reads each stall
                     ``overload-latency-ms``
``torn``             crash after applying a PREFIX of a ``mutate_many``
                     batch (:class:`InjectedCrashError`), the torn commit
                     that ``TornCommitRecovery`` heals on reopen
``lock``             lease expiry: the Nth lock check sees a skewed clock,
                     so the holder's claim reads as expired
``scan``             kill a row scan mid-stream, absorbed by an ordered
                     scan's per-range retry (``StandardScanner``,
                     ``load_csr``); an unordered scan (the sharded store)
                     has no retry and lets it out, as the reference's does
``superstep``        preempt an OLAP superstep (:class:`SuperstepPreempted`),
                     absorbed by the executor's checkpoint auto-resume
``cdc_torn_segment`` the Nth CDC log append writes half a frame and
                     crashes (``storage/cdc.py``)
===================  =====================================================

The fleet's kinds are the reference's and live: ``replica_kill`` and
``replica_restart`` (``fleet_hook``: the chaos harness kills the chosen
replica at its fleet tick and restarts it, the restart warming from the
shard-checkpoint pack; ``replica_target`` picks the victim),
``replica_partition`` (``arm_replica`` tells the victim's own plan to
fail its storage reads and writes for the window, so the router must
route around a replica that looks alive) and ``cdc_lagging_follower``
(``follower_lag``: ``server/fleet.py``'s ``CDCFollower`` skips applying
for the window; ``promote()`` forces through it). Their
``storage.faults.replica-*`` and ``follower-lag-*`` options are honoured.
The multi-device kinds (``sharded_hook``: shard preemption, collective
timeout, halo drop, straggler skew) are the reference's, pure and
journaled; the sharded executor (``parallel/sharded.py``) consults the
hook at every superstep boundary, and their ``storage.faults.shard-*``
options are honoured.
The watchdog's stalled lock (``stalled_lock``) and wedged thread
(``wedge_thread``) are decisions for the holder of an
``observability/continuous.py`` ``InstrumentedLock`` and for a worker
that reports its progress to the ``StallWatchdog``, as in the reference,
and their options are honoured.

Wiring: ``storage.faults.enabled`` makes ``open_graph`` wrap its store
manager (any backend) and expose the plan as ``graph.fault_plan``; the
lockers read ``lock_clock_ns``, the CDC log ``cdc_torn_write``, and the
OLAP computer forwards ``olap_hook`` into the executor as its
``fault_hook``.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from janusgraph_tpu_torch.exceptions import (
    CollectiveTimeout,
    HaloDropped,
    InjectedCrashError,
    InjectedFaultError,
    ShardPreempted,
    SuperstepPreempted,
)
from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KCVMutation,
    KeyColumnValueStore,
    KeyColumnValueStoreManager,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)

#: stores the injector touches by default — the data plane only. The id
#: authority, global config, durable logs, and lock stores stay clean so
#: recovery can always run (chaos that corrupts the repair path proves
#: nothing).
DEFAULT_FAULT_STORES = ("edgestore", "graphindex")

#: clock skew applied to a lock check chosen for lease expiry: one hour,
#: far past any sane locks.expiry-ms, so the holder's claim always reads
#: as expired regardless of tuning
LOCK_EXPIRY_SKEW_NS = 3_600 * 1_000_000_000


class FaultPlan:
    """A deterministic, seeded schedule of faults.

    Probabilistic kinds (read/write/latency) fire when
    ``hash(seed, kind, n) < rate`` for the kind's n-th operation; scheduled
    kinds (torn/lock/scan/superstep) fire at an exact per-kind operation
    index. Counters are per kind, so interleaving between kinds (e.g. a
    cache absorbing reads) never shifts another kind's schedule.
    """

    def __init__(
        self,
        seed: int = 0,
        read_error_rate: float = 0.0,
        write_error_rate: float = 0.0,
        latency_ms: float = 0.0,
        latency_rate: float = 0.0,
        torn_mutation_at: int = -1,
        lock_expiry_at: int = -1,
        scan_kill_at: int = -1,
        scan_kill_after_rows: int = 8,
        overload_at: int = -1,
        overload_ops: int = 0,
        overload_latency_ms: float = 0.0,
        preempt_superstep: int = -1,
        shard_preempt_superstep: int = -1,
        shard_preempt_shard: int = -1,
        collective_timeout_at: int = -1,
        halo_drop_at: int = -1,
        straggler_ms: float = 0.0,
        straggler_rate: float = 0.0,
        replica_kill_at: int = -1,
        replica_restart_at: int = -1,
        replica_partition_at: int = -1,
        replica_partition_ops: int = 0,
        replica_target: int = -1,
        cdc_torn_at: int = -1,
        follower_lag_at: int = -1,
        follower_lag_pulls: int = 0,
        stall_lock_at: int = -1,
        stall_lock_ms: float = 0.0,
        wedge_thread_at: int = -1,
        stores: Sequence[str] = DEFAULT_FAULT_STORES,
        journal_limit: int = 4096,
    ):
        self.seed = int(seed)
        self.read_error_rate = read_error_rate
        self.write_error_rate = write_error_rate
        self.latency_ms = latency_ms
        self.latency_rate = latency_rate
        self.overload_at = overload_at
        self.overload_ops = overload_ops
        self.overload_latency_ms = overload_latency_ms
        self.torn_mutation_at = torn_mutation_at
        self.lock_expiry_at = lock_expiry_at
        self.scan_kill_at = scan_kill_at
        self.scan_kill_after_rows = scan_kill_after_rows
        self.preempt_superstep = preempt_superstep
        self.shard_preempt_superstep = shard_preempt_superstep
        self.shard_preempt_shard = shard_preempt_shard
        self.collective_timeout_at = collective_timeout_at
        self.halo_drop_at = halo_drop_at
        self.straggler_ms = straggler_ms
        self.straggler_rate = straggler_rate
        self.replica_kill_at = replica_kill_at
        self.replica_restart_at = replica_restart_at
        self.replica_partition_at = replica_partition_at
        self.replica_partition_ops = replica_partition_ops
        self._replica_target_cfg = replica_target
        self.cdc_torn_at = cdc_torn_at
        self.follower_lag_at = follower_lag_at
        self.follower_lag_pulls = follower_lag_pulls
        self._cdc_torn_fired = False
        self._follower_lag_recorded = False
        self.stall_lock_at = stall_lock_at
        self.stall_lock_ms = stall_lock_ms
        self.wedge_thread_at = wedge_thread_at
        self._stall_lock_fired = False
        self._wedge_fired = False
        #: which fleet replica THIS plan instance belongs to (set by the
        #: fleet harness when wiring each replica's graph; -1 = not part
        #: of a fleet, so the partition window never applies)
        self.replica_index = -1
        self._replica_killed = False
        self._replica_restarted = False
        self._partition_recorded = False
        self.stores = tuple(stores)
        self.journal_limit = journal_limit
        #: injected-fault record: [{"kind", "n", ...}] — deterministic
        #: content only (no wall-clock), so two runs with one seed compare
        #: journal-equal
        self.journal: List[dict] = []
        self._counters: Dict[str, int] = {}
        self._preempted = False
        self._shard_preempted = False
        self._collective_fired = False
        self._halo_dropped = False
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg) -> "FaultPlan":
        """Build from the ``storage.faults.*`` option family."""
        stores = [
            s.strip()
            for s in cfg.get("storage.faults.stores").split(",")
            if s.strip()
        ] or list(DEFAULT_FAULT_STORES)
        return cls(
            seed=cfg.get("storage.faults.seed"),
            read_error_rate=cfg.get("storage.faults.read-error-rate"),
            write_error_rate=cfg.get("storage.faults.write-error-rate"),
            latency_ms=cfg.get("storage.faults.latency-ms"),
            latency_rate=cfg.get("storage.faults.latency-rate"),
            overload_at=cfg.get("storage.faults.overload-at"),
            overload_ops=cfg.get("storage.faults.overload-ops"),
            overload_latency_ms=cfg.get("storage.faults.overload-latency-ms"),
            torn_mutation_at=cfg.get("storage.faults.torn-mutation-at"),
            lock_expiry_at=cfg.get("storage.faults.lock-expiry-at"),
            scan_kill_at=cfg.get("storage.faults.scan-kill-at"),
            scan_kill_after_rows=cfg.get("storage.faults.scan-kill-after-rows"),
            preempt_superstep=cfg.get("storage.faults.preempt-superstep"),
            shard_preempt_superstep=cfg.get("storage.faults.shard-preempt-superstep"),
            shard_preempt_shard=cfg.get("storage.faults.shard-preempt-shard"),
            collective_timeout_at=cfg.get("storage.faults.shard-collective-timeout-at"),
            halo_drop_at=cfg.get("storage.faults.shard-halo-drop-at"),
            straggler_ms=cfg.get("storage.faults.shard-straggler-ms"),
            straggler_rate=cfg.get("storage.faults.shard-straggler-rate"),
            replica_kill_at=cfg.get("storage.faults.replica-kill-at"),
            replica_restart_at=cfg.get("storage.faults.replica-restart-at"),
            replica_partition_at=cfg.get("storage.faults.replica-partition-at"),
            replica_partition_ops=cfg.get("storage.faults.replica-partition-ops"),
            replica_target=cfg.get("storage.faults.replica-target"),
            cdc_torn_at=cfg.get("storage.faults.cdc-torn-at"),
            follower_lag_at=cfg.get("storage.faults.follower-lag-at"),
            follower_lag_pulls=cfg.get("storage.faults.follower-lag-pulls"),
            stall_lock_at=cfg.get("storage.faults.stall-lock-at"),
            stall_lock_ms=cfg.get("storage.faults.stall-lock-ms"),
            wedge_thread_at=cfg.get("storage.faults.wedge-thread-at"),
            stores=stores,
        )

    # ------------------------------------------------------------- decisions
    def _tick(self, kind: str) -> int:
        with self._lock:
            n = self._counters.get(kind, 0)
            self._counters[kind] = n + 1
            return n

    def _chance(self, kind: str, n: int, rate: float) -> bool:
        if rate <= 0.0:
            return False
        h = zlib.crc32(f"{self.seed}:{kind}:{n}".encode())
        return (h / 0xFFFFFFFF) < rate

    def _record(self, kind: str, n: int, **detail) -> None:
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        # graphlint: disable=JG110 -- kind is the fixed injected-fault taxonomy (storage/faults.py fault kinds)
        registry.counter(f"chaos.injected.{kind}").inc()
        registry.counter("chaos.injected.total").inc()
        # the black box sees every injected fault (deterministic fields
        # only, so seeded runs produce comparable event sequences)
        flight_recorder.record(
            "fault", kind=kind, n=n, seed=self.seed, **detail
        )
        with self._lock:
            if len(self.journal) < self.journal_limit:
                self.journal.append({"kind": kind, "n": n, **detail})

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # ------------------------------------------------------------ fleet hooks
    def replica_target(self, num_replicas: int) -> int:
        """The deterministically chosen victim replica for the fleet fault
        kinds: ``replica-target`` when configured, else seed-hashed — the
        same pure-function discipline as the shard-preemption choice."""
        if self._replica_target_cfg >= 0:
            return self._replica_target_cfg % max(1, num_replicas)
        return zlib.crc32(f"{self.seed}:replica".encode()) % max(
            1, num_replicas
        )

    def arm_replica(self, index: int, num_replicas: int) -> None:
        """Bind this plan instance to fleet replica ``index`` (each replica
        opens its own graph, so each carries its own plan). Only the
        target replica's plan executes the partition window."""
        self.replica_index = int(index)
        self._num_replicas = int(num_replicas)

    def _partition_active(self, n: int) -> bool:
        """Whether data-plane op index ``n`` of THIS replica's plan falls
        inside the seeded partition window (router sees the replica, the
        replica cannot reach storage)."""
        if (
            self.replica_partition_at < 0
            or self.replica_partition_ops <= 0
            or self.replica_index < 0
        ):
            return False
        if self.replica_index != self.replica_target(
            getattr(self, "_num_replicas", 1)
        ):
            return False
        return (
            self.replica_partition_at
            <= n
            < self.replica_partition_at + self.replica_partition_ops
        )

    def fleet_hook(self, num_replicas: int) -> List[dict]:
        """Fleet-tick hook, consulted once per traffic tick by the fleet
        chaos harness (the fleet's chaos stage, tests). Returns the
        scheduled fleet events for this tick — ``replica_kill`` at
        ``replica-kill-at``, ``replica_restart`` at ``replica-restart-at``
        — each fired once, journal-recorded, with the victim chosen by
        :meth:`replica_target`. The harness executes the decision (stops /
        restarts the server), mirroring how the executors absorb
        ``sharded_hook`` decisions."""
        n = self._tick("fleet")
        events: List[dict] = []
        target = self.replica_target(num_replicas)
        if not self._replica_killed and 0 <= self.replica_kill_at <= n:
            self._replica_killed = True
            self._record("replica_kill", n, replica=target)
            events.append({"kind": "replica_kill", "replica": target})
        if (
            self._replica_killed
            and not self._replica_restarted
            and 0 <= self.replica_restart_at <= n
        ):
            self._replica_restarted = True
            self._record("replica_restart", n, replica=target)
            events.append({"kind": "replica_restart", "replica": target})
        return events

    # ------------------------------------------------------------- cdc hooks
    def cdc_torn_write(self) -> bool:
        """Tear THIS tail append (a partial frame hits disk and the
        writer dies)? Fires once at ``cdc-torn-at`` — the torn-tail case
        CDCLog recovery contains to exactly one frame (storage/cdc.py)."""
        n = self._tick("cdc-append")
        if not self._cdc_torn_fired and 0 <= self.cdc_torn_at <= n:
            self._cdc_torn_fired = True
            self._record("cdc_torn_segment", n)
            return True
        return False

    def follower_lag(self) -> bool:
        """Stall THIS follower pull (skip applying, so staleness grows)?
        True across the window [follower-lag-at, +follower-lag-pulls);
        journaled once at the leading edge. The router must respond by
        sending freshness-hinted traffic back to the leader."""
        n = self._tick("follower-pull")
        if (
            self.follower_lag_at >= 0
            and self.follower_lag_pulls > 0
            and self.follower_lag_at
            <= n
            < self.follower_lag_at + self.follower_lag_pulls
        ):
            if not self._follower_lag_recorded:
                self._follower_lag_recorded = True
                self._record(
                    "cdc_lagging_follower", n,
                    pulls=self.follower_lag_pulls,
                )
            return True
        return False

    # -------------------------------------------------------- watchdog hooks
    def stalled_lock(self, lock: str = "instrumented") -> float:
        """Hold duration (ms) for THIS instrumented-lock acquisition: the
        scheduled op index returns ``stall-lock-ms`` once, every other op
        returns 0. The CALLER holds the lock for that long (the decision
        is pure; the side effect — a convoy the watchdog must catch —
        happens at the call site), so two runs with one seed journal
        byte-equal."""
        n = self._tick("stall_lock")
        if (
            not self._stall_lock_fired
            and self.stall_lock_ms > 0
            and 0 <= self.stall_lock_at <= n
        ):
            self._stall_lock_fired = True
            self._record(
                "stalled_lock", n, lock=lock, ms=self.stall_lock_ms
            )
            return self.stall_lock_ms
        return 0.0

    def wedge_thread(self) -> bool:
        """Wedge THIS worker op? Fires once at ``wedge-thread-at``; the
        caller parks the thread (on an event the harness releases), so
        the watchdog's progress checker sees active work that stops
        moving."""
        n = self._tick("wedge_thread")
        if not self._wedge_fired and 0 <= self.wedge_thread_at <= n:
            self._wedge_fired = True
            self._record("wedged_thread", n)
            return True
        return False

    # ----------------------------------------------------------- store hooks
    def before_read(self, store: str) -> None:
        n = self._tick("read")
        if self._partition_active(n):
            # journaled once at the leading edge (a window of failing ops
            # would flood the ring), raised for every op inside it
            if not self._partition_recorded:
                self._partition_recorded = True
                self._record(
                    "replica_partition", n,
                    replica=self.replica_index,
                    ops=self.replica_partition_ops,
                )
            raise InjectedFaultError(
                f"injected storage partition: replica "
                f"{self.replica_index} cannot reach storage (read #{n}, "
                f"seed {self.seed})"
            )
        if (
            self.overload_at >= 0
            and self.overload_latency_ms > 0
            and self.overload_at <= n < self.overload_at + self.overload_ops
        ):
            # the STORM is index-scheduled like every other kind, so one
            # seed reproduces one saturation window; journaled once at
            # its leading edge (per-op records would flood the ring)
            if n == self.overload_at:
                self._record(
                    "overload", n,
                    store=store, ops=self.overload_ops,
                    ms=self.overload_latency_ms,
                )
            time.sleep(self.overload_latency_ms / 1000.0)
        if self._chance("latency", n, self.latency_rate) and self.latency_ms:
            self._record("latency", n, store=store, ms=self.latency_ms)
            time.sleep(self.latency_ms / 1000.0)
        if self._chance("read", n, self.read_error_rate):
            self._record("read", n, store=store)
            raise InjectedFaultError(
                f"injected read fault #{n} on {store} (seed {self.seed})"
            )

    def before_write(self, store: str) -> None:
        n = self._tick("write")
        if self._partition_active(n):
            raise InjectedFaultError(
                f"injected storage partition: replica "
                f"{self.replica_index} cannot reach storage (write #{n}, "
                f"seed {self.seed})"
            )
        if self._chance("write", n, self.write_error_rate):
            self._record("write", n, store=store)
            raise InjectedFaultError(
                f"injected write fault #{n} on {store} (seed {self.seed})"
            )

    def mutate_many_decision(self) -> Tuple[int, bool]:
        """(op index, tear this batch?) for one mutate_many call. Write-rate
        faults for the batch path are drawn here too (before anything is
        applied, so a retry is safe). The scheduled tear takes precedence —
        a probabilistic fault on the same index must not consume it."""
        n = self._tick("mutate_many")
        if n == self.torn_mutation_at:
            return n, True
        if self._chance("write", n, self.write_error_rate):
            self._record("write", n, store="mutate_many")
            raise InjectedFaultError(
                f"injected batch-write fault #{n} (seed {self.seed})"
            )
        return n, False

    def record_torn(self, n: int, applied_rows: int, total_rows: int) -> None:
        self._record(
            "torn", n, applied_rows=applied_rows, total_rows=total_rows
        )

    def scan_decision(self) -> Tuple[int, bool]:
        """(scan index, kill this scan mid-stream?)."""
        n = self._tick("scan")
        return n, n == self.scan_kill_at

    def record_scan_kill(self, n: int, store: str, rows: int) -> None:
        self._record("scan", n, store=store, after_rows=rows)

    # ------------------------------------------------------------- lock hook
    def lock_clock_ns(self) -> int:
        """Clock source for ConsistentKeyLocker checks: the scheduled check
        sees a one-hour-skewed clock, so every live claim (the holder's
        included) reads as expired — the lock-lease-expiry fault."""
        n = self._tick("lock_check")
        if n == self.lock_expiry_at:
            self._record("lock", n, skew_ns=LOCK_EXPIRY_SKEW_NS)
            return time.time_ns() + LOCK_EXPIRY_SKEW_NS
        return time.time_ns()

    # ------------------------------------------------------------- OLAP hook
    def olap_hook(self, step: int) -> None:
        """Executor fault hook: raises SuperstepPreempted ONCE when the run
        reaches the scheduled superstep; the auto-resume replay passes."""
        if self.preempt_superstep < 0 or self._preempted:
            return
        if step >= self.preempt_superstep:
            self._preempted = True
            self._record("superstep", self._tick("superstep"), step=step)
            raise SuperstepPreempted(
                f"injected preemption at superstep {step} "
                f"(seed {self.seed})"
            )

    # -------------------------------------------------------- sharded hooks
    def straggler_decisions(
        self, step: int, num_shards: int
    ) -> List[Tuple[int, float]]:
        """[(shard, ms)] latency-skew decisions for one superstep. Pure in
        the ABSOLUTE (superstep, shard) pair — not a shared cursor — so a
        replayed superstep (auto-resume) sees the same skew both times."""
        if self.straggler_rate <= 0.0 or not self.straggler_ms:
            return []
        out = []
        for shard in range(num_shards):
            if self._chance(
                "straggler", step * num_shards + shard, self.straggler_rate
            ):
                out.append((shard, self.straggler_ms))
        return out

    def sharded_hook(self, step: int, num_shards: int) -> List[dict]:
        """Superstep-boundary hook for the sharded executor (consulted once
        per host-visible superstep with the mesh size). Executes, in order:

        1. straggler skew — sleeps once for the slowest selected shard
           (the SPMD program runs at the pace of its slowest participant)
           and returns the per-shard skew records for the executor's
           straggler detector;
        2. collective timeout — the scheduled collective index raises
           :class:`CollectiveTimeout` (once);
        3. halo drop — the scheduled exchange index raises
           :class:`HaloDropped` (once);
        4. shard preemption — reaching the scheduled superstep raises
           :class:`ShardPreempted` (once) for a deterministically chosen
           shard (``shard-preempt-shard``, or seed-hashed when -1).

        All raised kinds are ``SuperstepPreempted`` subclasses, absorbed by
        the cross-shard auto-resume (roll back to the last manifest).
        """
        stragglers = self.straggler_decisions(step, num_shards)
        events: List[dict] = []
        for shard, ms in stragglers:
            self._record(
                "straggler", step * num_shards + shard,
                step=step, shard=shard, ms=ms,
            )
            events.append({"step": step, "shard": shard, "ms": ms})
        if stragglers:
            # one sleep at the barrier: every shard waits on the slowest
            time.sleep(max(ms for _s, ms in stragglers) / 1000.0)
        n = self._tick("collective")
        if not self._collective_fired and n == self.collective_timeout_at:
            self._collective_fired = True
            self._record("collective", n, step=step)
            raise CollectiveTimeout(
                f"injected collective timeout at superstep {step} "
                f"(collective #{n}, seed {self.seed})"
            )
        h = self._tick("halo")
        if not self._halo_dropped and h == self.halo_drop_at:
            self._halo_dropped = True
            self._record("halo_drop", h, step=step)
            raise HaloDropped(
                f"injected dropped halo batch at superstep {step} "
                f"(exchange #{h}, seed {self.seed})"
            )
        if (
            not self._shard_preempted
            and self.shard_preempt_superstep >= 0
            and step >= self.shard_preempt_superstep
        ):
            self._shard_preempted = True
            shard = self.shard_preempt_shard
            if shard < 0:
                shard = zlib.crc32(f"{self.seed}:shard".encode()) % max(
                    1, num_shards
                )
            self._record(
                "shard_preempt", self._tick("shard_preempt"),
                step=step, shard=shard,
            )
            raise ShardPreempted(
                f"injected preemption of shard {shard} at superstep "
                f"{step} (seed {self.seed})"
            )
        # the single-device preemption schedule still applies on a mesh
        self.olap_hook(step)
        return events


# ---------------------------------------------------------------------------
# store wrappers


class FaultInjectingStore(KeyColumnValueStore):
    """Executes a FaultPlan in front of one wrapped store."""

    def __init__(self, wrapped: KeyColumnValueStore, plan: FaultPlan):
        self.wrapped = wrapped
        self.plan = plan

    @property
    def name(self) -> str:
        return self.wrapped.name

    def get_slice(self, query: KeySliceQuery, txh) -> EntryList:
        self.plan.before_read(self.name)
        return self.wrapped.get_slice(query, txh)

    def get_slice_multi(
        self, keys: Sequence[bytes], slice_query: SliceQuery, txh
    ) -> Dict[bytes, EntryList]:
        # one decision per batched call — a multi-slice is one backend op
        self.plan.before_read(self.name)
        return self.wrapped.get_slice_multi(keys, slice_query, txh)

    def mutate(self, key, additions, deletions, txh) -> None:
        self.plan.before_write(self.name)
        self.wrapped.mutate(key, additions, deletions, txh)

    def acquire_lock(self, key, column, expected_value, txh) -> None:
        self.wrapped.acquire_lock(key, column, expected_value, txh)

    def get_keys(self, query, txh) -> Iterator[Tuple[bytes, EntryList]]:
        n, kill = self.plan.scan_decision()
        rows = 0
        for key, entries in self.wrapped.get_keys(query, txh):
            if kill and rows >= self.plan.scan_kill_after_rows:
                self.plan.record_scan_kill(n, self.name, rows)
                raise InjectedFaultError(
                    f"injected scan kill #{n} on {self.name} after "
                    f"{rows} rows (seed {self.plan.seed})"
                )
            rows += 1
            yield key, entries

    def close(self) -> None:
        self.wrapped.close()


class FaultInjectingStoreManager(KeyColumnValueStoreManager):
    """Wraps a KeyColumnValueStoreManager; data-plane stores named in the
    plan get a FaultInjectingStore, everything else passes through."""

    def __init__(self, wrapped: KeyColumnValueStoreManager, plan: FaultPlan):
        self.wrapped = wrapped
        self.plan = plan
        self._stores: Dict[str, KeyColumnValueStore] = {}

    @property
    def features(self) -> StoreFeatures:
        return self.wrapped.features

    @property
    def ledger_self_accounting(self) -> bool:
        """Pass-through: a wrapped remote client accounts its own cells,
        so BackendTransaction must not count them a second time."""
        return getattr(self.wrapped, "ledger_self_accounting", False)

    @property
    def name(self) -> str:
        return f"faulty({self.wrapped.name})"

    def open_database(self, name: str) -> KeyColumnValueStore:
        store = self._stores.get(name)
        if store is None:
            store = self.wrapped.open_database(name)
            if name in self.plan.stores:
                store = FaultInjectingStore(store, self.plan)
            self._stores[name] = store
        return store

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return self.wrapped.begin_transaction(config)

    def mutate_many(
        self,
        mutations: Dict[str, Dict[bytes, KCVMutation]],
        txh: StoreTransaction,
    ) -> None:
        faulted = {s: rows for s, rows in mutations.items()
                   if s in self.plan.stores and rows}
        if faulted:
            n, tear = self.plan.mutate_many_decision()
            if tear:
                self._tear(mutations, txh, n)
                return  # unreachable: _tear always raises
        self.wrapped.mutate_many(mutations, txh)

    def _tear(self, mutations, txh, n: int) -> None:
        """Apply a deterministic PREFIX of the batch row-by-row (per-row
        application is atomic, the batch is not — exactly the guarantee a
        non-transactional backend gives), then crash. The suffix is lost:
        the torn-commit case."""
        rows = [
            (store_name, key, m)
            for store_name in sorted(mutations)
            for key, m in sorted(mutations[store_name].items())
            if not m.is_empty()
        ]
        applied = max(1, len(rows) // 2) if rows else 0
        for store_name, key, m in rows[:applied]:
            self.wrapped.open_database(store_name).mutate(
                key, m.additions, m.deletions, txh
            )
        self.plan.record_torn(n, applied, len(rows))
        raise InjectedCrashError(
            f"injected crash: batch torn after {applied}/{len(rows)} rows "
            f"(mutate_many #{n}, seed {self.plan.seed})"
        )

    def get_local_key_partition(self):
        return self.wrapped.get_local_key_partition()

    def close(self) -> None:
        self.wrapped.close()

    def clear_storage(self) -> None:
        self.wrapped.clear_storage()

    def exists(self) -> bool:
        return self.wrapped.exists()

    def __getattr__(self, item):
        # adapter-specific extras (shared index providers, host/port, ...)
        # resolve against the wrapped manager
        return getattr(self.wrapped, item)
