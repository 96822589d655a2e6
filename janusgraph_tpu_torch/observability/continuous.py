"""Continuous profiling plane: always-on sampling profiler, runtime
stall watchdog, and anomaly forensics bundles — the port's copy of
``janusgraph_tpu/observability/continuous.py``.

The other observability layers are request-scoped or pull-based (the
roofline ledger prices individual queries) and cannot say *where the
wall went* between two windows, or which thread holds the lock a waiter
is stuck on. This module answers both at runtime:

``SamplingProfiler``
    A daemon thread samples ``sys._current_frames()`` at
    ``metrics.profile-hz`` and folds every stack into collapsed-stack
    lines (the same ``frame;frame;frame weight_us`` vocabulary as
    :mod:`janusgraph_tpu_torch.observability.profiler`'s ``flame_lines``).
    Stacks accumulate into the *current* window, which is sealed into a
    bounded ring whenever a ``MetricsHistory`` window lands — the
    profiler registers a history listener, so a flame window carries the
    exact ``seq`` of the metrics window it joins and the two can be
    correlated after the fact.  When history is not running the profiler
    self-seals on a fallback cadence (tagged ``seq=-1``).  Every
    sampling pass self-measures both wall and CPU cost
    (``time.thread_time`` is exact for the calling thread); the lifetime
    CPU ratio is exported as ``observability.profiler.overhead_cpu_pct``
    (and read by ``/healthz``'s ``profiler`` block).  Per-thread CPU attribution
    reads ``/proc/self/task/<tid>/stat`` utime+stime on Linux and
    degrades to empty elsewhere.

``InstrumentedLock`` / ``StallWatchdog``
    The runtime check of lock discipline.  An
    ``InstrumentedLock`` records its owner (thread ident + acquire
    time) and registers blocked waiters with the watchdog; the watchdog
    thread scans the wait table and the registered progress sources
    (active requests, supersteps, CDC pulls) and flights
    ``lock_convoy`` / ``stall`` events — edge-triggered per key — each
    carrying the owner's stack snatched from the sampler ring, plus the
    wait-for edge (waiter → owner).  A confirmed stall triggers a
    forensics bundle.

``BundleWriter``
    On SLO page (healthz ok→degraded flip), watchdog stall, or
    unhandled server error, capture one bundle: recent flame windows +
    flight ring + timeseries tail + all-thread stack dump + active
    request table + watchdog state.  Edge-triggered and rate-limited
    (``metrics.bundle-min-interval-s``), written tmp+rename atomic with
    bounded retention (``metrics.bundle-retention``), served at
    ``GET /debug/bundle``.

``flamediff``
    Frame-by-frame diff of two flame sources (windows or bench
    artifacts): per-frame aggregated weight deltas ranked by |delta|
    (deterministic name tie-break), served at ``GET
    /debug/profile/diff``; the reference's bench diff attaches the top
    frame deltas to a regressed cell (ROADMAP Queue A #5.6b).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from janusgraph_tpu_torch.observability.flight import recorder as flight_recorder
from janusgraph_tpu_torch.observability.profiler import _FRAME_SANITIZE
from janusgraph_tpu_torch.observability.timeseries import history

__all__ = [
    "BundleWriter",
    "InstrumentedLock",
    "SamplingProfiler",
    "StallWatchdog",
    "bundle_writer",
    "flamediff",
    "flame_from_artifact",
    "sampling_profiler",
    "watchdog",
]

_MAX_DEPTH = 64


#: fold caches: most sampled threads are BLOCKED (selectors, queue
#: waits), so the same frame chain recurs sample after sample — caching
#: the collapsed string by the chain's code objects turns the hot fold
#: into one tuple-hash lookup. Keys hold the code objects alive, so ids
#: can never alias; both caches are bounded.
_LABEL_CACHE: Dict[object, str] = {}
_STACK_CACHE: Dict[tuple, str] = {}


def _frame_label(code) -> str:
    got = _LABEL_CACHE.get(code)
    if got is None:
        name = "%s:%s" % (
            os.path.basename(code.co_filename), code.co_name,
        )
        got = _FRAME_SANITIZE.sub("_", name)
        if len(_LABEL_CACHE) < 8192:
            _LABEL_CACHE[code] = got
    return got


def _fold_frame(frame) -> str:
    """Collapse a frame chain into a root→leaf ``file:func;...`` stack
    string, sanitized with the shared flame vocabulary."""
    codes: List[object] = []
    f = frame
    while f is not None and len(codes) < _MAX_DEPTH:
        codes.append(f.f_code)
        f = f.f_back
    key = tuple(codes)
    got = _STACK_CACHE.get(key)
    if got is None:
        got = ";".join(_frame_label(c) for c in reversed(codes))
        if len(_STACK_CACHE) < 4096:
            _STACK_CACHE[key] = got
    return got


def _proc_thread_cpu() -> Dict[int, float]:
    """Per-native-thread CPU seconds from /proc (Linux); empty map when
    the proc filesystem is unavailable (macOS, sandboxes)."""
    out: Dict[int, float] = {}
    task_dir = "/proc/self/task"
    try:
        tids = os.listdir(task_dir)
    except OSError:
        return out
    tick = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
    for tid in tids:
        try:
            with open("%s/%s/stat" % (task_dir, tid), "rb") as fh:
                raw = fh.read().decode("ascii", "replace")
            # field 2 is "(comm)" and may contain spaces — split after it
            rest = raw.rsplit(")", 1)[1].split()
            utime, stime = int(rest[11]), int(rest[12])
            out[int(tid)] = (utime + stime) / float(tick)
        except (OSError, ValueError, IndexError):
            continue
    return out


class SamplingProfiler:
    """Always-on low-rate stack sampler with self-measured overhead.

    Lifecycle mirrors ``MetricsHistory``: a module singleton the server
    starts/stops; ``configure()`` is applied at graph-open time from
    ``metrics.profile-*`` keys.  ``sample_once()`` and
    ``seal_window(seq)`` are public so fake-clock tests drive the
    profiler without the thread.
    """

    def __init__(
        self,
        hz: float = 20.0,
        max_windows: int = 60,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.hz = float(hz)
        self.enabled = False
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(max_windows))
        self._pending: Dict[str, int] = {}
        self._pending_samples = 0
        self._last_stacks: Dict[int, Tuple[str, str]] = {}
        self._prev_thread_cpu: Dict[int, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started_at = 0.0
        self._last_seal = 0.0
        self._last_seal_seq = 0
        self._died: Optional[str] = None
        #: per-seal hooks (the telemetry bus); called AFTER the ring
        #: lock is released, exceptions swallowed — the same contract
        #: as MetricsHistory listeners
        self._seal_listeners: List[Callable[[dict], None]] = []
        # lifetime self-cost (wall AND cpu,
        # 1-core honest — cpu_pct is against elapsed wall on one core)
        self._overhead_wall_s = 0.0
        self._overhead_cpu_s = 0.0
        self._samples = 0
        self._windows_sealed = 0

    # ------------------------------------------------------------- config
    def configure(
        self,
        hz: Optional[float] = None,
        max_windows: Optional[int] = None,
        enabled: Optional[bool] = None,
    ) -> None:
        with self._lock:
            if hz is not None and hz > 0:
                self.hz = float(hz)
            if max_windows is not None and max_windows != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=int(max_windows))
            if enabled is not None:
                self.enabled = bool(enabled)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start the sampler thread (idempotent) and attach the
        history listener so flame windows seal in lockstep with metrics
        windows."""
        with self._lock:
            self.enabled = True
            self._died = None
        history.add_listener(self._on_history_window)
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        now = self._clock()
        with self._lock:
            self._started_at = now
            self._last_seal = now
        self._thread = threading.Thread(
            target=self._run, name="profiler-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.enabled = False
        history.remove_listener(self._on_history_window)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        try:
            while not self._stop.wait(1.0 / max(self.hz, 0.1)):
                self.sample_once()
                # fallback sealing when MetricsHistory is not running —
                # windows stay bounded, just unaligned (seq=-1)
                horizon = max(4.0 * history.interval_s, 2.0)
                if self._clock() - self._last_seal > horizon:
                    self.seal_window(seq=-1)
        except Exception as e:  # noqa: BLE001 - record before dying
            with self._lock:
                self._died = repr(e)
            flight_recorder.record(
                "thread_error", thread="profiler-sampler", error=repr(e)
            )

    # ----------------------------------------------------------- sampling
    def sample_once(self) -> int:
        """One sampling pass over all threads except the sampler itself.
        Returns the number of stacks folded.  Self-cost (wall + CPU) is
        accumulated; ``thread_time`` measures exactly this thread."""
        w0 = time.perf_counter()
        c0 = time.thread_time()
        own = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        period_us = int(1e6 / max(self.hz, 0.1))
        folded = 0
        # fold outside the lock: the stack cache makes this cheap, and
        # the lock hold shrinks to dict updates
        stacks = [
            (ident, _fold_frame(frame))
            for ident, frame in frames.items()
            if ident != own
        ]
        with self._lock:
            for ident, stack in stacks:
                if not stack:
                    continue
                self._pending[stack] = (
                    self._pending.get(stack, 0) + period_us
                )
                self._last_stacks[ident] = (
                    names.get(ident, str(ident)), stack
                )
            self._pending_samples += 1
            self._samples += 1
            self._overhead_wall_s += time.perf_counter() - w0
            self._overhead_cpu_s += time.thread_time() - c0
            folded = len(frames) - (1 if own in frames else 0)
        return folded

    def add_seal_listener(self, fn: Callable[[dict], None]) -> None:
        """Register a per-seal hook (the streaming telemetry bus);
        runs on the sealing thread after the flame window lands."""
        if fn not in self._seal_listeners:
            self._seal_listeners.append(fn)

    def remove_seal_listener(self, fn) -> None:
        if fn in self._seal_listeners:
            self._seal_listeners.remove(fn)

    def last_seal_seq(self) -> int:
        """Seq of the newest HISTORY-ALIGNED flame seal — the ``flame``
        stream's cursor position (fallback seals carry seq=-1 and have
        no stable cursor, so they never advance this)."""
        with self._lock:
            return self._last_seal_seq

    def _on_history_window(self, window: dict) -> None:
        self.seal_window(seq=int(window.get("seq", -1)))

    def seal_window(self, seq: int = -1) -> dict:
        """Seal the pending stacks into a flame window tagged with the
        metrics-history window ``seq`` it joins."""
        cpu_now = _proc_thread_cpu()
        names = {
            t.native_id: t.name
            for t in threading.enumerate()
            if t.native_id is not None
        }
        with self._lock:
            cpu_ms: Dict[str, float] = {}
            for tid, secs in cpu_now.items():
                prev = self._prev_thread_cpu.get(tid)
                if prev is not None and secs >= prev:
                    delta = (secs - prev) * 1000.0
                    if delta > 0:
                        cpu_ms[names.get(tid, str(tid))] = round(delta, 3)
            self._prev_thread_cpu = cpu_now
            window = {
                "seq": seq,
                "ts": self._wall(),
                "t": self._clock(),
                "samples": self._pending_samples,
                "stacks": dict(self._pending),
                "cpu_ms_by_thread": cpu_ms,
            }
            self._ring.append(window)
            self._pending = {}
            self._pending_samples = 0
            self._windows_sealed += 1
            self._last_seal = self._clock()
            if seq > 0:
                self._last_seal_seq = seq
            listeners = list(self._seal_listeners)
        from janusgraph_tpu_torch.observability import registry

        registry.set_gauge(
            "observability.profiler.overhead_cpu_pct",
            round(self.overhead_cpu_pct(), 4),
        )
        for fn in listeners:
            try:
                fn(window)
            except Exception:  # noqa: BLE001 - a listener must not kill sealing
                pass
        return window

    # ----------------------------------------------------------- querying
    def windows(self, last: int = 0) -> List[dict]:
        """The most recent ``last`` sealed flame windows (0 = all),
        oldest first."""
        with self._lock:
            wins = list(self._ring)
        return wins[-last:] if last > 0 else wins

    def merged_stacks(self, last: int = 0) -> Dict[str, int]:
        """Collapsed stacks merged across the requested windows plus the
        current pending window."""
        merged: Dict[str, int] = {}
        for w in self.windows(last):
            for stack, us in w["stacks"].items():
                merged[stack] = merged.get(stack, 0) + us
        with self._lock:
            for stack, us in self._pending.items():
                merged[stack] = merged.get(stack, 0) + us
        return merged

    def flame_text(self, last: int = 0) -> str:
        """Collapsed-stack flamegraph text (``stack weight_us`` lines,
        heaviest first) — the same vocabulary as ``flame_lines``."""
        merged = self.merged_stacks(last)
        lines = [
            "%s %d" % (stack, us)
            for stack, us in sorted(
                merged.items(), key=lambda kv: (-kv[1], kv[0])
            )
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def stack_of(self, ident: int) -> Optional[str]:
        """Last sampled stack for a thread ident — the watchdog snatches
        a lock owner's stack from here."""
        with self._lock:
            got = self._last_stacks.get(ident)
        return got[1] if got else None

    def overhead_cpu_pct(self) -> float:
        elapsed = self._clock() - self._started_at
        if elapsed <= 0 or self._started_at == 0.0:
            return 0.0
        return 100.0 * self._overhead_cpu_s / elapsed

    def overhead_wall_pct(self) -> float:
        elapsed = self._clock() - self._started_at
        if elapsed <= 0 or self._started_at == 0.0:
            return 0.0
        return 100.0 * self._overhead_wall_s / elapsed

    def status(self) -> dict:
        """The /healthz ``profiler`` sub-block."""
        with self._lock:
            windows = len(self._ring)
        return {
            "enabled": self.enabled,
            "alive": self.alive,
            "died": self._died,
            "hz": self.hz,
            "samples": self._samples,
            "windows": windows,
            "windows_sealed": self._windows_sealed,
            "overhead_cpu_pct": round(self.overhead_cpu_pct(), 4),
            "overhead_wall_pct": round(self.overhead_wall_pct(), 4),
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending = {}
            self._pending_samples = 0
            self._last_stacks = {}
            self._prev_thread_cpu = {}
            self._overhead_wall_s = 0.0
            self._overhead_cpu_s = 0.0
            self._samples = 0
            self._windows_sealed = 0
            self._last_seal_seq = 0
            self._died = None
            self._started_at = 0.0
            self._seal_listeners.clear()


class InstrumentedLock:
    """A named lock whose owner and waiters are visible to the
    watchdog.  The fast path is one extra non-blocking try; contended
    acquires register in the watchdog wait table so a convoy is
    observable *while it is happening*, not only after release."""

    def __init__(
        self,
        name: str,
        watchdog: Optional["StallWatchdog"] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self._lock = threading.Lock()
        self._clock = clock
        self._meta = threading.Lock()
        self.owner: Optional[int] = None
        self.owner_name: str = ""
        self.owner_since: float = 0.0
        self.waiters: Dict[int, Tuple[str, float]] = {}
        self._wd = watchdog if watchdog is not None else watchdog_singleton()
        self._wd.register_lock(self)

    def acquire(self, timeout: float = -1) -> bool:
        me = threading.get_ident()
        my_name = threading.current_thread().name
        settled = False
        ok = self._lock.acquire(blocking=False)
        try:
            if not ok:
                with self._meta:
                    self.waiters[me] = (my_name, self._clock())
                ok = self._acquire_contended(me, timeout)
            if ok:
                self._granted(me, my_name)
            settled = True
            return ok
        finally:
            # bookkeeping raised after the inner lock was won: release
            # it rather than leak a lock the caller never learned it
            # holds
            if ok and not settled:
                self._lock.release()

    def _acquire_contended(self, me: int, timeout: float) -> bool:
        """Blocking inner acquire for the contended path; the caller
        already registered ``me`` in the waiter table — popped here on
        every exit."""
        settled = False
        ok = self._lock.acquire(timeout=timeout if timeout >= 0 else -1)
        try:
            with self._meta:
                self.waiters.pop(me, None)
            settled = True
            return ok
        finally:
            if ok and not settled:
                self._lock.release()

    def _granted(self, ident: int, name: str) -> None:
        with self._meta:
            self.owner = ident
            self.owner_name = name
            self.owner_since = self._clock()

    def release(self) -> None:
        with self._meta:
            self.owner = None
            self.owner_name = ""
            self.owner_since = 0.0
        self._lock.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def state(self) -> dict:
        with self._meta:
            return {
                "name": self.name,
                "owner": self.owner_name or None,
                "held_s": (
                    round(self._clock() - self.owner_since, 3)
                    if self.owner is not None
                    else 0.0
                ),
                "waiters": len(self.waiters),
            }


class StallWatchdog:
    """Scans instrumented-lock wait tables and progress sources and
    flights ``lock_convoy`` / ``stall`` events with the owner's sampled
    stack.  Edge-triggered per (kind, key): one event per episode, the
    key re-arms when the waiter is granted / progress resumes."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.interval_s = 1.0
        self.stall_s = 5.0
        self.enabled = False
        self._clock = clock
        self._lock = threading.Lock()
        self._locks: List[InstrumentedLock] = []
        self._progress: Dict[str, Callable[[], dict]] = {}
        self._last_progress: Dict[str, Tuple[object, float]] = {}
        self._flagged: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._died: Optional[str] = None
        self.events = 0

    def configure(
        self,
        interval_s: Optional[float] = None,
        stall_s: Optional[float] = None,
        enabled: Optional[bool] = None,
    ) -> None:
        if interval_s is not None and interval_s > 0:
            self.interval_s = float(interval_s)
        if stall_s is not None and stall_s > 0:
            self.stall_s = float(stall_s)
        if enabled is not None:
            self.enabled = bool(enabled)

    # -------------------------------------------------------- registration
    def register_lock(self, lock: InstrumentedLock) -> None:
        with self._lock:
            if lock not in self._locks:
                self._locks.append(lock)

    def register_progress(
        self, name: str, fn: Callable[[], dict]
    ) -> None:
        """``fn`` returns ``{"active": int, "progress": value}`` —
        active work whose progress value does not change for
        ``stall_s`` is a stall."""
        with self._lock:
            self._progress[name] = fn

    def unregister_progress(self, name: str) -> None:
        with self._lock:
            self._progress.pop(name, None)
            self._last_progress.pop(name, None)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            self.enabled = True
            self._died = None
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.enabled = False
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.interval_s):
                self.check()
        except Exception as e:  # noqa: BLE001 - record before dying
            with self._lock:
                self._died = repr(e)
            flight_recorder.record(
                "thread_error", thread="stall-watchdog", error=repr(e)
            )

    # ----------------------------------------------------------- detection
    def check(self, now: Optional[float] = None) -> List[dict]:
        """One scan pass (public so fake-clock tests drive it).
        Returns the events flighted this pass.  Detection mutates the
        edge-trigger state under ``_lock``; flighting and bundle
        capture run after release so forensics I/O never happens while
        the watchdog lock is held."""
        from janusgraph_tpu_torch.observability import registry

        now = self._clock() if now is None else now
        convoys: List[dict] = []
        stalls: List[dict] = []
        with self._lock:
            locks = list(self._locks)
            progress = dict(self._progress)
        for lk in locks:
            with lk._meta:
                waiters = dict(lk.waiters)
                owner = lk.owner
                owner_name = lk.owner_name
            live_keys = {("lock", lk.name, ident) for ident in waiters}
            with self._lock:
                # re-arm keys whose waiter was granted or gave up
                self._flagged = {
                    k
                    for k in self._flagged
                    if not (
                        k[0] == "lock"
                        and k[1] == lk.name
                        and k not in live_keys
                    )
                }
                for ident, (wname, since) in waiters.items():
                    key = ("lock", lk.name, ident)
                    wait_s = now - since
                    if wait_s < self.stall_s or key in self._flagged:
                        continue
                    self._flagged.add(key)
                    self.events += 1
                    convoys.append({
                        "lock": lk.name,
                        "waiter": wname,
                        "wait_s": round(wait_s, 3),
                        "owner": owner,
                        "owner_name": owner_name,
                    })
        for name, fn in progress.items():
            try:
                snap = fn() or {}
            except Exception:  # noqa: BLE001 - a bad source must not kill scans
                flight_recorder.record(
                    "thread_error", thread="stall-watchdog",
                    error="progress source %r raised" % name,
                )
                continue
            active = int(snap.get("active", 0))
            value = snap.get("progress")
            key = ("progress", name)
            with self._lock:
                if active <= 0:
                    self._last_progress.pop(name, None)
                    self._flagged.discard(key)
                    continue
                prev = self._last_progress.get(name)
                if prev is None or prev[0] != value:
                    self._last_progress[name] = (value, now)
                    self._flagged.discard(key)
                    continue
                stuck_s = now - prev[1]
                if stuck_s < self.stall_s or key in self._flagged:
                    continue
                self._flagged.add(key)
                self.events += 1
            stalls.append({
                "source": name,
                "active": active,
                "stuck_s": round(stuck_s, 3),
                "progress": value,
            })
        fired: List[dict] = []
        for c in convoys:
            owner_stack = (
                sampling_profiler.stack_of(c["owner"])
                if c["owner"] is not None
                else None
            )
            ev = flight_recorder.record(
                "lock_convoy",
                lock=c["lock"],
                waiter=c["waiter"],
                wait_s=c["wait_s"],
                owner=c["owner_name"] or None,
                owner_stack=owner_stack,
                wait_for=[c["waiter"], c["owner_name"] or "?"],
            )
            registry.counter("observability.watchdog.lock_convoys").inc()
            fired.append(ev)
            bundle_writer.capture(reason="lock-convoy")
        for s in stalls:
            ev = flight_recorder.record("stall", **s)
            registry.counter("observability.watchdog.stalls").inc()
            fired.append(ev)
            bundle_writer.capture(reason="stall")
        return fired

    def state(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "alive": self.alive,
                "died": self._died,
                "interval_s": self.interval_s,
                "stall_s": self.stall_s,
                "locks": [lk.state() for lk in self._locks],
                "sources": sorted(self._progress),
                "events": self.events,
            }

    def reset(self) -> None:
        with self._lock:
            self._locks = []
            self._progress = {}
            self._last_progress = {}
            self._flagged = set()
            self.events = 0
            self._died = None


class BundleWriter:
    """Anomaly forensics bundles: one self-contained JSON per episode,
    written tmp+rename atomic with bounded retention.  ``capture()``
    never raises — forensics must not take down the server it is
    diagnosing."""

    def __init__(
        self,
        directory: str = "",
        retention: int = 8,
        min_interval_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.directory = directory
        self.retention = int(retention)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._last_capture = 0.0
        self._seq = 0
        self.written = 0
        self.suppressed = 0
        self._request_table: Optional[Callable[[], list]] = None

    def configure(
        self,
        directory: Optional[str] = None,
        retention: Optional[int] = None,
        min_interval_s: Optional[float] = None,
    ) -> None:
        if directory is not None:
            self.directory = directory
        if retention is not None and retention > 0:
            self.retention = int(retention)
        if min_interval_s is not None and min_interval_s >= 0:
            self.min_interval_s = float(min_interval_s)

    def set_request_table(
        self, provider: Optional[Callable[[], list]]
    ) -> None:
        """The server registers its active-request table here."""
        self._request_table = provider

    # ------------------------------------------------------------- capture
    def _all_stacks(self) -> Dict[str, List[str]]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out: Dict[str, List[str]] = {}
        for ident, frame in sys._current_frames().items():
            label = "%s (%d)" % (names.get(ident, "?"), ident)
            out[label] = [
                ln.rstrip("\n")
                for ln in traceback.format_stack(frame)
            ]
        return out

    def build(self, reason: str) -> dict:
        requests: list = []
        if self._request_table is not None:
            try:
                requests = list(self._request_table())
            except Exception:  # noqa: BLE001 - a bad provider must not block forensics
                requests = [{"error": "request-table provider raised"}]
        return {
            "reason": reason,
            "ts": self._wall(),
            "pid": os.getpid(),
            "flame_windows": sampling_profiler.windows(last=5),
            "profiler": sampling_profiler.status(),
            "flight": flight_recorder.snapshot(),
            "timeseries": history.windows(last=10),
            "stacks": self._all_stacks(),
            "requests": requests,
            "watchdog": watchdog.state(),
        }

    def capture(
        self, reason: str, force: bool = False
    ) -> Optional[str]:
        """Capture one bundle (edge-triggered callers + this rate limit
        keep a flapping pager from writing a bundle per second).
        Returns the path, or None when suppressed or disabled."""
        if not self.directory:
            return None
        from janusgraph_tpu_torch.observability import registry

        with self._lock:
            now = self._clock()
            if (
                not force
                and self._last_capture > 0.0
                and now - self._last_capture < self.min_interval_s
            ):
                self.suppressed += 1
                registry.counter(
                    "observability.bundles.suppressed"
                ).inc()
                return None
            self._last_capture = now
            self._seq += 1
            seq = self._seq
        try:
            bundle = self.build(reason)
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(
                self.directory,
                "bundle-%d-%04d.json" % (os.getpid(), seq),
            )
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(bundle, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
            with self._lock:
                self.written += 1
            registry.counter("observability.bundles.written").inc()
            flight_recorder.record("bundle", reason=reason, path=path)
            self._prune()
            return path
        except Exception as e:  # noqa: BLE001 - forensics must not raise
            flight_recorder.record(
                "thread_error", thread="bundle-writer", error=repr(e)
            )
            return None

    def _prune(self) -> None:
        try:
            names = sorted(
                n
                for n in os.listdir(self.directory)
                if n.startswith("bundle-") and n.endswith(".json")
            )
            for n in names[: max(0, len(names) - self.retention)]:
                os.remove(os.path.join(self.directory, n))
        except OSError:
            pass

    # ------------------------------------------------------------- reading
    def list_bundles(self) -> List[str]:
        if not self.directory:
            return []
        try:
            return sorted(
                os.path.join(self.directory, n)
                for n in os.listdir(self.directory)
                if n.startswith("bundle-") and n.endswith(".json")
            )
        except OSError:
            return []

    def latest(self) -> Optional[dict]:
        """Newest readable bundle — a torn/partial file (killed writer)
        is skipped, not fatal."""
        for path in reversed(self.list_bundles()):
            try:
                with open(path) as fh:
                    got = json.load(fh)
                got["path"] = path
                return got
            except (OSError, ValueError):
                continue
        return None

    def status(self) -> dict:
        return {
            "dir": self.directory or None,
            "retention": self.retention,
            "min_interval_s": self.min_interval_s,
            "written": self.written,
            "suppressed": self.suppressed,
            "on_disk": len(self.list_bundles()),
        }

    def reset(self) -> None:
        with self._lock:
            self._last_capture = 0.0
            self._seq = 0
            self.written = 0
            self.suppressed = 0
            self._request_table = None


# ---------------------------------------------------------------- flamediff
def _frame_weights(stacks: Dict[str, float]) -> Dict[str, float]:
    """Aggregate weight per *frame*: each stack's weight is charged once
    to every distinct frame on it (inclusive time, recursion-safe)."""
    out: Dict[str, float] = {}
    for stack, weight in stacks.items():
        for frame in set(stack.split(";")):
            if frame:
                out[frame] = out.get(frame, 0.0) + float(weight)
    return out


def flame_from_artifact(obj: dict) -> Optional[Dict[str, float]]:
    """Pull collapsed stacks out of a bench stage/artifact dict, a
    flame window, or a raw ``{stack: weight}`` map."""
    if not isinstance(obj, dict):
        return None
    if "stacks" in obj and isinstance(obj["stacks"], dict):
        return {str(k): float(v) for k, v in obj["stacks"].items()}
    flame = obj.get("flame")
    if isinstance(flame, dict):
        inner = flame.get("stacks", flame)
        if isinstance(inner, dict):
            return {str(k): float(v) for k, v in inner.items()}
    if obj and all(
        isinstance(v, (int, float)) for v in obj.values()
    ):
        return {str(k): float(v) for k, v in obj.items()}
    return None


def flamediff(
    old, new, top: int = 0
) -> List[dict]:
    """Frame-by-frame diff of two flame sources.  Ranked by |delta|
    descending with a deterministic frame-name tie-break, so two runs
    over the same artifacts produce byte-identical output."""
    old_map = flame_from_artifact(old) if isinstance(old, dict) else None
    new_map = flame_from_artifact(new) if isinstance(new, dict) else None
    if old_map is None or new_map is None:
        return []
    old_f = _frame_weights(old_map)
    new_f = _frame_weights(new_map)
    rows = []
    for frame in sorted(set(old_f) | set(new_f)):
        o = old_f.get(frame, 0.0)
        n = new_f.get(frame, 0.0)
        delta = n - o
        if delta == 0.0:
            continue
        rows.append(
            {
                "frame": frame,
                "old_us": round(o, 1),
                "new_us": round(n, 1),
                "delta_us": round(delta, 1),
                "delta_pct": (
                    round(100.0 * delta / o, 2) if o > 0 else None
                ),
            }
        )
    rows.sort(key=lambda r: (-abs(r["delta_us"]), r["frame"]))
    return rows[:top] if top > 0 else rows


# --------------------------------------------------------------- singletons
sampling_profiler = SamplingProfiler()
watchdog = StallWatchdog()
bundle_writer = BundleWriter()


def watchdog_singleton() -> StallWatchdog:
    return watchdog
