"""Declarative SLOs + multi-window burn-rate alerting over the history —
the port's copy of ``janusgraph_tpu/observability/slo.py``.

The Google-SRE burn-rate discipline, evaluated entirely in-process over
the :mod:`~janusgraph_tpu_torch.observability.timeseries` window ring:

- an **SLO spec** (:class:`SLOSpec`) declares an objective over one of
  three signal kinds the stack already measures:

  ``availability``  good/bad from two counters — by default the admission
                    plane's ``server.admission.admitted`` vs ``.shed``:
                    the non-shed fraction of arriving requests.
  ``latency``       the fraction of requests under a per-window threshold,
                    from timer bucket deltas. The threshold is explicit
                    (``threshold_ms``) or **priced**: per-digest-class
                    request timers (``server.request.digest.<digest>``)
                    are each held to ``price_factor x`` the digest's
                    measured mean cost from the admission price book
                    — an expensive analytical shape is allowed
                    its measured cost, a point-read is not.
  ``freshness``     a staleness gauge vs a bound — by default the OLAP
                    spillover snapshot's write-staleness
                    (``olap.spillover.staleness``, the delta-CSR signal).

- the **burn rate** is ``error_rate / error_budget`` with
  ``error_budget = 1 - objective``: burn 1.0 spends the budget exactly at
  the objective's horizon; burn 14.4 spends a 30-day budget in 2 days —
  the classic page threshold. Each spec is evaluated over a FAST and a
  SLOW window pair (counts of history windows) and alerts only when BOTH
  exceed the threshold — the fast window gives reaction time, the slow
  window vetoes blips.

- the **alert ladder** is hysteretic like the brownout ladder: severity
  ``ok -> ticket -> page`` enters when both windows burn past the rung's
  threshold and exits only after ``clear_windows`` consecutive
  evaluations below ``exit_factor x`` that threshold. Every transition is
  a flight ``slo_burn`` event and the per-spec gauges
  ``observability.slo.<name>.{burn_fast,burn_slow,severity}`` track the
  state (spec names are a small declared set — bounded cardinality).

- a page-severity burn makes ``/healthz`` report ``degraded``, which
  rides the existing ok->degraded edge trigger: the flight ring is on
  disk before anyone asks what happened.

Everything is deterministic on a fake clock: evaluation is driven by
:meth:`MetricsHistory.sample` (the engine registers as a listener), so a
test that feeds synthetic traffic and calls ``sample()`` N times gets a
byte-stable alert sequence.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from janusgraph_tpu_torch.observability.timeseries import (
    MetricsHistory,
    bucket_upper_index,
)

SEV_OK = "ok"
SEV_TICKET = "ticket"
SEV_PAGE = "page"

#: per-digest-class request timer prefix (server/server.py records one
#: timer per price-book digest — bounded by the top-K-evicted book)
DIGEST_TIMER_PREFIX = "server.request.digest."


@dataclass
class SLOSpec:
    """One declarative objective. ``kind`` selects the signal:

    - ``availability``: ``good_counter``/``bad_counter`` deltas.
    - ``latency``: ``metric`` timer's under-threshold fraction; with
      ``metric=""`` the per-digest-class timers are evaluated jointly,
      each priced at ``price_factor x`` its book mean (floored at
      ``threshold_ms``).
    - ``freshness``: ``gauge`` vs ``max_staleness`` (mean over the
      window; burn = staleness / bound).
    """

    name: str
    kind: str  # availability | latency | freshness
    objective: float = 0.999
    # availability
    good_counter: str = "server.admission.admitted"
    bad_counter: str = "server.admission.shed"
    # latency
    metric: str = ""
    threshold_ms: float = 250.0
    price_factor: float = 4.0
    # freshness
    gauge: str = "olap.spillover.staleness"
    max_staleness: float = 10_000.0
    # burn windows + ladder
    fast_windows: int = 3
    slow_windows: int = 36
    page_burn: float = 14.4
    ticket_burn: float = 6.0
    exit_factor: float = 0.9
    clear_windows: int = 2

    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.objective)


@dataclass
class _AlertState:
    severity: str = SEV_OK
    clear_streak: int = 0
    fast_burn: float = 0.0
    slow_burn: float = 0.0
    entered_seq: int = 0
    transitions: int = 0
    detail: dict = field(default_factory=dict)


def default_specs(
    availability_objective: float = 0.999,
    latency_objective: float = 0.99,
    latency_threshold_ms: float = 250.0,
    freshness_max_staleness: float = 10_000.0,
    fast_windows: int = 3,
    slow_windows: int = 36,
    page_burn: float = 14.4,
    ticket_burn: float = 6.0,
) -> List[SLOSpec]:
    """The stock spec set the server installs (``metrics.slo-*`` keys)."""
    common = dict(
        fast_windows=fast_windows, slow_windows=slow_windows,
        page_burn=page_burn, ticket_burn=ticket_burn,
    )
    return [
        SLOSpec(
            name="availability", kind="availability",
            objective=availability_objective, **common,
        ),
        SLOSpec(
            name="latency", kind="latency", objective=latency_objective,
            threshold_ms=latency_threshold_ms, **common,
        ),
        SLOSpec(
            name="olap_freshness", kind="freshness",
            objective=latency_objective,
            max_staleness=freshness_max_staleness, **common,
        ),
    ]


class SLOEngine:
    """Evaluates every spec once per history window; owns alert state.

    ``price_book_fn`` returns the active DigestTable used to price
    per-digest latency thresholds (None = unpriced, the flat
    ``threshold_ms`` applies to every class)."""

    def __init__(
        self,
        history: MetricsHistory,
        specs: Optional[List[SLOSpec]] = None,
        price_book_fn=None,
    ):
        self.history = history
        self.specs: List[SLOSpec] = list(specs or [])
        self.price_book_fn = price_book_fn
        self._states: Dict[str, _AlertState] = {}
        self._lock = threading.Lock()
        self._events = 0

    # ------------------------------------------------------------- lifecycle
    def install(self) -> "SLOEngine":
        """Register on the history's per-window hook (idempotent)."""
        self.history.add_listener(self._on_window)
        return self

    def uninstall(self) -> None:
        self.history.remove_listener(self._on_window)

    def _on_window(self, _window: dict) -> None:
        self.evaluate()

    def reset(self) -> None:
        with self._lock:
            self._states.clear()
            self._events = 0

    # ------------------------------------------------------------ evaluation
    def _rates(self, spec: SLOSpec, windows: List[dict]) -> tuple:
        """(bad, total) over a window slice for one spec."""
        if spec.kind == "availability":
            good = bad = 0
            for w in windows:
                good += w["counters"].get(spec.good_counter, 0)
                bad += w["counters"].get(spec.bad_counter, 0)
            return float(bad), float(good + bad)
        if spec.kind == "latency":
            if spec.metric:
                thresholds = {spec.metric: spec.threshold_ms}
            else:
                thresholds = self._digest_thresholds(spec, windows)
            bad = total = 0
            for name, threshold_ms in thresholds.items():
                # timers store nanoseconds; observations in buckets whose
                # upper bound exceeds the threshold MAY exceed it — exact
                # to the log2 ladder's 2x resolution, and deterministic
                cut = bucket_upper_index(threshold_ms * 1e6)
                for w in windows:
                    s = w["series"].get(name)
                    if s is None:
                        continue
                    total += s["count"]
                    bad += sum(s["buckets"][cut:])
            return float(bad), float(total)
        if spec.kind == "freshness":
            vals = [
                w["gauges"][spec.gauge]
                for w in windows if spec.gauge in w["gauges"]
            ]
            if not vals:
                return 0.0, 0.0
            # burn = mean staleness / bound, scaled through the budget so
            # "staleness at the bound" burns at exactly 1/budget (page-
            # worthy): the freshness objective is a hard ceiling, not a
            # fraction of requests
            mean = sum(vals) / len(vals)
            over = mean / max(spec.max_staleness, 1e-9)
            return over * spec.error_budget(), 1.0
        raise ValueError(f"unknown SLO kind {spec.kind!r}")

    def _digest_thresholds(
        self, spec: SLOSpec, windows: List[dict]
    ) -> Dict[str, float]:
        """Per-digest-class thresholds priced from the price book: each
        ``server.request.digest.<digest>`` timer seen in the slice is held
        to ``price_factor x`` its measured mean cost, floored at the flat
        ``threshold_ms`` so cheap shapes keep a sane bound."""
        names = set()
        for w in windows:
            for n in w["series"]:
                if n.startswith(DIGEST_TIMER_PREFIX):
                    names.add(n)
        book = self.price_book_fn() if self.price_book_fn else None
        out: Dict[str, float] = {}
        for n in names:
            digest = n[len(DIGEST_TIMER_PREFIX):]
            priced = book.mean_cost_ms(digest) if book is not None else None
            out[n] = max(
                spec.threshold_ms,
                spec.price_factor * priced if priced else 0.0,
            )
        return out

    def _burn(self, spec: SLOSpec, windows: List[dict]) -> float:
        bad, total = self._rates(spec, windows)
        if total <= 0:
            return 0.0
        return (bad / total) / spec.error_budget()

    def evaluate(self) -> List[dict]:
        """One evaluation pass over every spec; returns the current alert
        snapshot (also the /healthz ``slo`` block's ``alerts``)."""
        from janusgraph_tpu_torch.observability import registry

        slow = self.history.windows(
            max((s.slow_windows for s in self.specs), default=0)
        )
        out = []
        for spec in self.specs:
            fast_burn = self._burn(spec, slow[-spec.fast_windows:])
            slow_burn = self._burn(spec, slow[-spec.slow_windows:])
            with self._lock:
                st = self._states.setdefault(spec.name, _AlertState())
                st.fast_burn = round(fast_burn, 4)
                st.slow_burn = round(slow_burn, 4)
                self._step(spec, st, fast_burn, slow_burn)
                out.append(self._snapshot_one(spec, st))
            sev_val = {
                SEV_OK: 0.0, SEV_TICKET: 1.0, SEV_PAGE: 2.0,
            }[st.severity]
            for suffix, value in (
                (".burn_fast", st.fast_burn),
                (".burn_slow", st.slow_burn),
                (".severity", sev_val),
            ):
                registry.set_gauge(
                    "observability.slo." + spec.name + suffix, value
                )
        return out

    def _step(
        self, spec: SLOSpec, st: _AlertState, fast: float, slow: float
    ) -> None:
        """Hysteretic severity ladder (lock held). Enter a rung when BOTH
        windows burn past its threshold; exit one rung after
        ``clear_windows`` consecutive evaluations below ``exit_factor x``
        the CURRENT rung's threshold."""
        both = min(fast, slow)
        target = st.severity
        if both >= spec.page_burn:
            target = SEV_PAGE
        elif both >= spec.ticket_burn and st.severity == SEV_OK:
            target = SEV_TICKET
        if target != st.severity and _rank(target) > _rank(st.severity):
            self._transition(spec, st, target, "enter", fast, slow)
            st.clear_streak = 0
            return
        if st.severity == SEV_OK:
            st.clear_streak = 0
            return
        rung_burn = (
            spec.page_burn if st.severity == SEV_PAGE else spec.ticket_burn
        )
        if both < rung_burn * spec.exit_factor:
            st.clear_streak += 1
            if st.clear_streak >= spec.clear_windows:
                lower = (
                    SEV_TICKET if st.severity == SEV_PAGE else SEV_OK
                )
                self._transition(spec, st, lower, "exit", fast, slow)
                st.clear_streak = 0
        else:
            st.clear_streak = 0

    def _transition(
        self, spec, st: _AlertState, severity: str, direction: str,
        fast: float, slow: float,
    ) -> None:
        from janusgraph_tpu_torch.observability import (
            flight_recorder,
            get_logger,
            registry,
        )

        st.severity = severity
        st.transitions += 1
        self._events += 1
        registry.counter("observability.slo.transitions").inc()
        flight_recorder.record(
            "slo_burn",
            slo=spec.name, kind=spec.kind, severity=severity,
            direction=direction,
            fast_burn=round(fast, 4), slow_burn=round(slow, 4),
            objective=spec.objective,
        )
        get_logger("observability.slo").warning(
            "slo-burn-transition",
            slo=spec.name, severity=severity, direction=direction,
            fast_burn=round(fast, 4), slow_burn=round(slow, 4),
        )

    # -------------------------------------------------------------- queries
    def _snapshot_one(self, spec: SLOSpec, st: _AlertState) -> dict:
        return {
            "name": spec.name,
            "kind": spec.kind,
            "objective": spec.objective,
            "severity": st.severity,
            "fast_burn": st.fast_burn,
            "slow_burn": st.slow_burn,
            "fast_windows": spec.fast_windows,
            "slow_windows": spec.slow_windows,
            "transitions": st.transitions,
        }

    def snapshot(self) -> dict:
        """The /healthz ``slo`` block."""
        with self._lock:
            alerts = [
                self._snapshot_one(spec, self._states[spec.name])
                for spec in self.specs
                if spec.name in self._states
            ]
        paging = [a["name"] for a in alerts if a["severity"] == SEV_PAGE]
        return {
            "specs": len(self.specs),
            "evaluated": len(alerts),
            "paging": paging,
            "worst": max(
                (a["severity"] for a in alerts),
                key=_rank, default=SEV_OK,
            ),
            "alerts": alerts,
        }

    def paging(self) -> bool:
        """True while any spec sits at page severity — /healthz folds
        this into its degraded verdict (and therefore the flight-dump
        edge trigger)."""
        with self._lock:
            return any(
                s.severity == SEV_PAGE for s in self._states.values()
            )


def _rank(sev: str) -> int:
    return {SEV_OK: 0, SEV_TICKET: 1, SEV_PAGE: 2}[sev]


#: process-wide engine over the process-wide history; the server installs
#: the stock specs at start() (metrics.slo-* keys) and /healthz reads it
from janusgraph_tpu_torch.observability.timeseries import history as _history

slo_engine = SLOEngine(_history)
