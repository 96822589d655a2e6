"""The port's store cache, retry guard and read-only backend held to the
JAX package's, after the reference's ``tests/test_backend.py`` (cache and
backend cases) and the retry-guard cases of ``test_config_r5.py``.

Each case runs on both packages with the same calls and must end the same
way: the slice cache's hits, misses, invalidations (write-through, at
commit, ``clear_caches``), LRU bound, TTL and clean-wait window; the graph
reads through it by default (``cache.db-cache``, the edgestore/index split
of ``cache.edgestore-fraction``) and not at all when it is off;
``index_query_uncached`` reads past it; ``backend_op.execute`` replays
temporary failures up to ``storage.write-attempts`` and lets permanent
ones through, and a backend's reads and flush ride it
(``storage.retry-time-ms``, ``storage.backoff-*``); ``storage.read-only``
refuses writes. Counts and rows are exact.
"""

import time
from types import SimpleNamespace

import pytest

from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import PermanentBackendError as RefPermanent
from janusgraph_tpu.exceptions import TemporaryBackendError as RefTemporary
from janusgraph_tpu.storage import backend as ref_backend
from janusgraph_tpu.storage import backend_op as ref_backend_op
from janusgraph_tpu.storage import cache as ref_cache
from janusgraph_tpu.storage import kcvs as ref_kcvs
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import PermanentBackendError, TemporaryBackendError
from janusgraph_tpu_torch.storage import backend, backend_op, cache, kcvs
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

PKGS = {
    "ref": SimpleNamespace(open=ref_open_graph, Manager=RefManager, backend=ref_backend,
                           cache=ref_cache, kcvs=ref_kcvs, op=ref_backend_op,
                           Temporary=RefTemporary, Permanent=RefPermanent),
    "port": SimpleNamespace(open=open_graph, Manager=InMemoryStoreManager, backend=backend,
                            cache=cache, kcvs=kcvs, op=backend_op,
                            Temporary=TemporaryBackendError, Permanent=PermanentBackendError),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def _q(pkg, key=b"k"):
    return pkg.kcvs.KeySliceQuery(key, pkg.kcvs.SliceQuery())


def test_cache_hits_invalidation_and_isolation(pkg):
    m = pkg.Manager()
    raw, tx = m.open_database("c"), m.begin_transaction()
    cached = pkg.cache.ExpirationCacheStore(raw, max_entries=10)
    raw.mutate(b"k", [(b"c1", b"v1")], [], tx)
    assert cached.get_slice(_q(pkg), tx) == [(b"c1", b"v1")]
    res = cached.get_slice(_q(pkg), tx)
    res.append((b"zz", b"junk"))  # the caller's copy
    assert (cached.metrics.hits, cached.metrics.misses) == (1, 1)
    cached.mutate(b"k", [(b"c2", b"v2")], [], tx)  # write-through invalidates
    assert cached.get_slice(_q(pkg), tx) == [(b"c1", b"v1"), (b"c2", b"v2")]
    assert (cached.metrics.misses, cached.metrics.invalidations) == (2, 1)
    raw.mutate(b"k", [(b"c3", b"v3")], [], tx)  # behind the cache's back
    assert len(cached.get_slice(_q(pkg), tx)) == 2
    cached.invalidate_all()
    assert len(cached.get_slice(_q(pkg), tx)) == 3
    assert cached.wrapped is raw and cached.name == "c"
    # scans bypass the cache
    assert [k for k, _ in cached.get_keys(pkg.kcvs.SliceQuery(), tx)] == [b"k"]


def test_cache_lru_ttl_and_clean_wait(pkg):
    m = pkg.Manager()
    raw, tx = m.open_database("c"), m.begin_transaction()
    lru = pkg.cache.ExpirationCacheStore(raw, max_entries=3)
    for i in range(5):
        raw.mutate(b"k%d" % i, [(b"c", b"v")], [], tx)
        lru.get_slice(_q(pkg, b"k%d" % i), tx)
    assert len(lru._cache) == 3
    ttl = pkg.cache.ExpirationCacheStore(raw, ttl_seconds=0.05)
    ttl.get_slice(_q(pkg, b"k0"), tx)
    ttl.get_slice(_q(pkg, b"k0"), tx)
    time.sleep(0.08)
    ttl.get_slice(_q(pkg, b"k0"), tx)
    assert (ttl.metrics.hits, ttl.metrics.misses) == (1, 2)
    wait = pkg.cache.ExpirationCacheStore(raw, clean_wait_seconds=60.0)
    wait.mutate(b"k1", [(b"d", b"w")], [], tx)
    wait.get_slice(_q(pkg, b"k1"), tx)
    wait.get_slice(_q(pkg, b"k1"), tx)
    assert wait.metrics.hits == 0  # not re-admitted inside the window


def test_graph_reads_through_the_cache_by_default(pkg):
    g = pkg.open({"cache.db-cache-size": 1000, "cache.edgestore-fraction": 0.75})
    es, ix = g.backend.edgestore, g.backend.indexstore
    assert isinstance(es, pkg.cache.ExpirationCacheStore)
    assert (es._max, ix._max, es._ttl) == (750, 250, 10.0)
    tx = g.new_transaction()
    v = tx.add_vertex(name="a")
    tx.commit()
    hits = es.metrics.hits
    assert g.new_transaction().get_vertex(v.id).value("name") == "a"
    assert g.new_transaction().get_vertex(v.id).value("name") == "a"
    assert es.metrics.hits > hits
    tx = g.new_transaction()
    tx.get_vertex(v.id).property("name", "b")
    tx.commit()  # the commit invalidates the rows it wrote
    assert g.new_transaction().get_vertex(v.id).value("name") == "b"
    g.backend.clear_caches()
    assert not es._cache and not ix._cache
    btx = g.backend.begin_transaction()
    q = pkg.kcvs.KeySliceQuery(b"\x00sn\x00name", pkg.kcvs.SliceQuery())
    assert btx.index_query_uncached(q) == btx.index_query(q) != []
    g.close()
    off = pkg.open({"cache.db-cache": False, "cache.db-cache-time-ms": 0.0})
    assert not isinstance(off.backend.edgestore, pkg.cache.ExpirationCacheStore)
    off.close()


def test_commit_invalidates_and_rollback_discards(pkg):
    be = pkg.backend.Backend(pkg.Manager())
    tx = be.begin_transaction()
    q = _q(pkg, b"k1")
    assert tx.edge_store_query(q) == []  # caches the empty result
    tx.mutate_edges(b"k1", [(b"c", b"v")], [])
    tx.commit()
    assert be.begin_transaction().edge_store_query(q) == [(b"c", b"v")]
    tx = be.begin_transaction()
    tx.mutate_edges(b"k1", [], [b"c"])
    tx.rollback()
    assert be.begin_transaction().edge_store_query(q) == [(b"c", b"v")]


def _flaky(pkg, fails, error=None):
    calls = []

    def op():
        calls.append(1)
        if len(calls) <= fails:
            raise (error or pkg.Temporary)("flake")
        return "ok"

    return op, calls


def test_retry_guard(pkg):
    op, calls = _flaky(pkg, 2)
    assert pkg.op.execute(op, max_time_s=5.0, base_delay_s=0.001) == "ok"
    assert len(calls) == 3
    op, calls = _flaky(pkg, 5)
    with pytest.raises(pkg.Temporary):
        pkg.op.execute(op, max_time_s=5.0, base_delay_s=0.001, max_attempts=2)
    assert len(calls) == 2
    op, calls = _flaky(pkg, 5, pkg.Permanent)
    with pytest.raises(pkg.Permanent):
        pkg.op.execute(op, max_time_s=5.0, base_delay_s=0.001)
    assert len(calls) == 1
    op, calls = _flaky(pkg, 100)
    t0 = time.monotonic()
    with pytest.raises(pkg.Temporary):
        pkg.op.execute(op, max_time_s=0.05, base_delay_s=0.001, max_delay_s=0.005)
    assert time.monotonic() - t0 < 1.0 and len(calls) > 2


def test_backend_reads_and_flush_ride_the_guard(pkg):
    g = pkg.open({"storage.retry-time-ms": 5000.0, "storage.backoff-base-ms": 1.0,
                  "storage.backoff-max-ms": 2.0, "storage.write-attempts": 3})
    be = g.backend
    assert (be.retry_time_s, be.backoff_base_s, be.backoff_max_s, be.retry_attempts) == (
        5.0, 0.001, 0.002, 3)
    raw = be.edgestore.wrapped
    real_get, real_many = raw.get_slice, be.manager.mutate_many
    fails = {"get": 2, "many": 2}

    def get_slice(query, txh):
        if fails["get"]:
            fails["get"] -= 1
            raise pkg.Temporary("read flake")
        return real_get(query, txh)

    def mutate_many(mutations, txh):
        if fails["many"]:
            fails["many"] -= 1
            raise pkg.Temporary("write flake")
        return real_many(mutations, txh)

    raw.get_slice, be.manager.mutate_many = get_slice, mutate_many
    tx = g.new_transaction()
    v = tx.add_vertex(name="a")
    tx.commit()
    assert fails["many"] == 0
    be.clear_caches()
    assert g.new_transaction().get_vertex(v.id).value("name") == "a"
    assert fails["get"] == 0
    g.close()


def test_read_only_backend_refuses_writes(pkg):
    m = pkg.Manager()
    pkg.open(store_manager=m).close()
    g = pkg.open({"storage.read-only": True}, store_manager=m)
    tx = g.new_transaction()
    with pytest.raises(pkg.Permanent, match="read-only: id-block claims"):
        tx.add_vertex()  # its id block would be claimed in the id store
    tx.rollback()
    btx = g.backend.begin_transaction()
    with pytest.raises(pkg.Permanent, match="read-only"):
        btx.mutate_edges(b"k", [(b"c", b"v")], [])
    with pytest.raises(pkg.Permanent, match="read-only"):
        g.backend.set_global_config("x", b"1")
    g.close()
