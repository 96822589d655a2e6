"""The port's circuit breaker held to the JAX package's: both breakers are
driven through the same sequence of successes, temporary and permanent
failures and clock steps (an injected clock), and after every step they are
in the same state, admitted or refused the call alike, and counted the same
trips and rejections. Exact equality: these are states and counts."""

import pytest

from janusgraph_tpu import exceptions as ref_exceptions
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.storage import circuit as ref_circuit
from janusgraph_tpu_torch import exceptions
from janusgraph_tpu_torch.observability import flight_recorder, registry
from janusgraph_tpu_torch.storage import circuit


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _step(pkg_circuit, pkg_exc, breaker, clock, action):
    """One step: ("ok"|"temp"|"perm", None) runs a call with that outcome,
    ("tick", dt) moves the clock; returns what the caller saw."""
    kind, arg = action
    if kind == "tick":
        clock.t += arg
        return "tick"

    def call():
        if kind == "temp":
            raise pkg_exc.TemporaryBackendError("down")
        if kind == "perm":
            raise pkg_exc.PermanentBackendError("answered")
        return "value"

    try:
        return breaker.call(call)
    except pkg_exc.CircuitOpenError:
        return "rejected"
    except pkg_exc.TemporaryBackendError:
        return "temp"
    except pkg_exc.PermanentBackendError:
        return "perm"


SEQUENCES = {
    "trip_and_recover": [("temp", None)] * 3 + [("ok", None), ("tick", 0.5), ("tick", 0.6),
                                                ("ok", None), ("temp", None)],
    "half_open_failure_reopens": [("temp", None)] * 3 + [("tick", 1.1), ("temp", None),
                                                         ("ok", None), ("tick", 1.0),
                                                         ("ok", None), ("ok", None)],
    "permanent_resets_the_count": [("temp", None), ("temp", None), ("perm", None),
                                   ("temp", None), ("temp", None), ("ok", None),
                                   ("temp", None)] + [("temp", None)] * 3,
    "rejections_while_open": [("temp", None)] * 3 + [("ok", None)] * 4
                             + [("tick", 0.99), ("ok", None), ("tick", 0.02), ("ok", None)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
@pytest.mark.parametrize("threshold,probes", [(3, 1), (1, 2)])
def test_breakers_walk_the_same_states(name, threshold, probes):
    label = f"twin.{name}.{threshold}.{probes}"
    clocks = (Clock(), Clock())
    mine = circuit.CircuitBreaker(label, failure_threshold=threshold, reset_timeout_s=1.0,
                                  half_open_probes=probes, clock=clocks[0])
    ref = ref_circuit.CircuitBreaker(label, failure_threshold=threshold, reset_timeout_s=1.0,
                                     half_open_probes=probes, clock=clocks[1])
    seen = []
    for action in SEQUENCES[name]:
        a = _step(circuit, exceptions, mine, clocks[0], action)
        b = _step(ref_circuit, ref_exceptions, ref, clocks[1], action)
        assert (a, mine.state, mine._failures) == (b, ref.state, ref._failures), action
        seen.append(mine.state)
    for metric in ("trips", "rejected"):
        key = f"breaker.{label}.{metric}"
        assert registry.snapshot().get(key, {}).get("count", 0) == \
            ref_registry.snapshot().get(key, {}).get("count", 0)
    gauge = f"breaker.{label}.state"
    assert registry.snapshot()[gauge]["value"] == ref_registry.snapshot()[gauge]["value"]
    assert circuit.OPEN in seen


def test_transitions_are_flight_events_and_permanent_errors_keep_it_closed():
    flight_recorder.reset()
    clock = Clock()
    b = circuit.CircuitBreaker("twin.flight", failure_threshold=2, reset_timeout_s=1.0,
                               clock=clock)
    for _ in range(5):
        _step(circuit, exceptions, b, clock, ("perm", None))
    assert b.state == circuit.CLOSED
    for _ in range(2):
        _step(circuit, exceptions, b, clock, ("temp", None))
    assert b.state == circuit.OPEN
    clock.t += 1.0
    assert b.state == circuit.HALF_OPEN
    assert _step(circuit, exceptions, b, clock, ("ok", None)) == "value"
    events = [(e["from_state"], e["to_state"])
              for e in flight_recorder.events("breaker") if e["name"] == "twin.flight"]
    assert events == [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
    assert issubclass(exceptions.CircuitOpenError, exceptions.PermanentBackendError)
    assert circuit.STATE_VALUES == ref_circuit.STATE_VALUES
