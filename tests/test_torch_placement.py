"""The port's ID placement strategies held to the JAX package's (after the
reference's ``tests/test_placement.py``): property-hash co-location against
round-robin spread, wired through ``ids.placement``. ``stable_hash`` is
equal in both packages over the same values, and a graph of each package
with the same writes gives its vertices the same ids, so the same
partitions. Exact equality throughout."""

import numpy as np
import pytest

from janusgraph_tpu.core import placement as ref_placement
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.placement import (
    PropertyPlacementStrategy,
    SimpleBulkPlacementStrategy,
    make_placement_strategy,
    stable_hash,
)
from janusgraph_tpu_torch.exceptions import ConfigurationError


def test_simple_spreads_round_robin():
    s = SimpleBulkPlacementStrategy()
    got = [s.partition_for(None, None, 4) for _ in range(8)]
    assert got == [0, 1, 2, 3, 0, 1, 2, 3]


def test_property_colocates_same_value():
    s = PropertyPlacementStrategy("region")
    parts = {s.partition_for(None, {"region": "emea"}, 32) for _ in range(10)}
    assert len(parts) == 1
    # a missing key falls back to the spread (round robin over calls)
    a = s.partition_for(None, {}, 4)
    b = s.partition_for(None, {}, 4)
    assert (a, b) == (0, 1)


VALUES = ["emea", "", "ünïcode", b"x", b"", 42, -7, 3.5, True, None, (1, "a"), 2 ** 70]


@pytest.mark.parametrize("value", VALUES, ids=[repr(v) for v in VALUES])
def test_stable_hash_equals_the_reference(value):
    assert stable_hash(value) == stable_hash(value) == ref_placement.stable_hash(value)


def test_strategies_choose_the_reference_partitions():
    rng = np.random.default_rng(3)
    props = [{"region": f"r{int(i)}"} if i % 5 else {} for i in rng.integers(0, 50, 200)]
    for name, key in (("simple", ""), ("property", "region")):
        mine = make_placement_strategy(name, key)
        ref = ref_placement.make_placement_strategy(name, key)
        for n in (1, 4, 32):
            assert [mine.partition_for(None, p, n) for p in props] == \
                [ref.partition_for(None, p, n) for p in props]


def _graph_partitions(open_fn, config):
    g = open_fn(dict({"ids.placement": "property", "ids.placement-key": "region",
                      "schema.default": "auto"}, **config))
    try:
        tx = g.new_transaction()
        emea = [tx.add_vertex(region="emea", name=f"e{i}") for i in range(6)]
        apac = [tx.add_vertex(region="apac", name=f"a{i}") for i in range(6)]
        loose = [tx.add_vertex(name=f"n{i}") for i in range(4)]
        tx.commit()
        return [[g.idm.get_partition_id(v.id) for v in vs] for vs in (emea, apac, loose)], \
            [v.id for v in emea + apac + loose]
    finally:
        g.close()


def test_graph_level_property_placement():
    (p_emea, p_apac, p_loose), ids = _graph_partitions(open_graph, {})
    assert len(set(p_emea)) == 1, "same region value must co-locate"
    assert len(set(p_apac)) == 1
    assert len(set(p_loose)) > 1  # no key: the round-robin spread
    ref = _graph_partitions(ref_open_graph, {"computer.sharded-auto": False})
    assert ([p_emea, p_apac, p_loose], ids) == ref


def test_property_strategy_requires_key():
    with pytest.raises(ConfigurationError):
        make_placement_strategy("property", "")
    with pytest.raises(ConfigurationError):
        make_placement_strategy("nope")
    with pytest.raises(ConfigurationError):
        open_graph({"ids.placement": "property"})
    with pytest.raises(ConfigurationError):
        open_graph({"ids.placement": "hashed"})


def test_default_graph_keeps_round_robin_spread():
    g = open_graph()
    tx = g.new_transaction()
    vs = [tx.add_vertex() for _ in range(8)]
    tx.commit()
    parts = [g.idm.get_partition_id(v.id) for v in vs]
    assert len(set(parts)) > 1  # spread, not all in one partition
    g.close()
