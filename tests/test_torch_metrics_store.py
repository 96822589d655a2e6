"""The metrics-instrumented store forwards multi-key slices and lock
claims, held to the JAX package.

With ``metrics.enabled`` on and ``cache.db-cache`` off, ``Backend`` hands
its raw stores to ``MetricInstrumentedStore`` with no slice cache above
it, so a transaction's multi-vertex read reaches the instrumented store's
``get_slice_multi``. The port's store used to lack it and fell to the base
class's per-key loop: one ``getSlice`` per key and no ``getSliceMulti``,
which also bypassed the remote store's parallel fan-out and the sharded
store's per-node batches. The same transactions on both packages must now
call the wrapped store's ``get_slice_multi`` once per batch and count the
same store-level timers.
"""

import pytest

from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.core.codecs import Direction as RefDirection
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.storage.cache import ExpirationCacheStore as RefCacheStore
from janusgraph_tpu.util.metrics import MetricInstrumentedStore as RefMetricStore
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.observability import registry
from janusgraph_tpu_torch.storage.cache import ExpirationCacheStore
from janusgraph_tpu_torch.util.metrics import MetricInstrumentedStore

N = 20
TIMERS = ("storage.edgestore.getSliceMulti", "storage.edgestore.getSlice")
PACKAGES = {
    "reference": (ref_open_graph, RefDirection, ref_registry),
    "port": (open_graph, Direction, registry),
}


def _count(reg, name):
    entry = reg.snapshot().get(name)
    return 0 if entry is None else entry["count"]


def _graph(package, batch_size):
    opener, direction, reg = PACKAGES[package]
    g = opener({"metrics.enabled": True, "cache.db-cache": False,
                "query.batch-size": batch_size, "computer.executor": "cpu",
                "ids.authority-wait-ms": 0.0})
    tx = g.new_transaction()
    vs = [tx.add_vertex(name=f"v{i}") for i in range(N)]
    for i in range(N):
        tx.add_edge(vs[i], "link", vs[(i + 1) % N])
    tx.commit()
    raw = g.backend.edgestore.wrapped
    calls = []
    inner = raw.get_slice_multi

    def spy(keys, query, txh):
        calls.append(len(keys))
        return inner(keys, query, txh)

    raw.get_slice_multi = spy
    return g, [v.id for v in vs], direction, reg, calls


def _observe(package, batch_size):
    g, vids, direction, reg, calls = _graph(package, batch_size)
    try:
        before = {t: _count(reg, t) for t in TIMERS}
        tx = g.new_transaction()
        vertices = [tx.get_vertex(v) for v in vids]
        tx.prefetch(vertices, direction.OUT, ["link"])
        edges = [len(tx.get_edges(v, direction.OUT, ["link"])) for v in vertices]
        tx.rollback()
        gained = {t: _count(reg, t) - before[t] for t in TIMERS}
        return calls, gained, edges
    finally:
        g.close()


@pytest.mark.parametrize("batch_size", [N, 8])
def test_prefetch_reaches_the_wrapped_stores_multi_slice(batch_size):
    ref_calls, ref_gained, ref_edges = _observe("reference", batch_size)
    calls, gained, edges = _observe("port", batch_size)
    batches = -(-N // batch_size)
    assert ref_calls == calls == [min(batch_size, N - i) for i in range(0, N, batch_size)]
    assert gained == ref_gained
    assert gained["storage.edgestore.getSliceMulti"] == batches
    assert edges == ref_edges == [1] * N


def test_the_instrumented_store_spans_and_times_a_lock_claim():
    """acquire_lock reaches the wrapped store inside a ``store.acquireLock``
    span and is timed as ``acquireLock``, as in the reference; the cache
    store forwards it too."""
    seen = []

    class Spy:
        name = "edgestore"

        def acquire_lock(self, key, column, expected, txh):
            seen.append((key, column, expected))
            return "held"

    for metric_store, cache_store, reg in (
        (RefMetricStore, RefCacheStore, ref_registry),
        (MetricInstrumentedStore, ExpirationCacheStore, registry),
    ):
        before = _count(reg, "locktest.edgestore.acquireLock")
        store = metric_store(Spy(), prefix="locktest")
        assert cache_store(store, 4).acquire_lock(b"k", b"c", b"v", None) == "held"
        assert _count(reg, "locktest.edgestore.acquireLock") == before + 1
    assert seen == [(b"k", b"c", b"v")] * 2


def test_both_stores_forward_the_same_calls():
    """Every public store call of the reference's instrumented store and
    cache store exists on the port's."""
    for ref_cls, cls in ((RefMetricStore, MetricInstrumentedStore),
                         (RefCacheStore, ExpirationCacheStore)):
        ref_calls = {n for n in vars(ref_cls) if not n.startswith("_")}
        assert ref_calls <= {n for n in vars(cls) if not n.startswith("_")}

