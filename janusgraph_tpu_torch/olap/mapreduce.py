"""MapReduce stage over a run's final vertex states — the port of
``janusgraph_tpu/olap/mapreduce.py``.

The map-reduce phase of a graph computer as array passes on the host: map()
returns whole (keys, values) arrays, reduce is a vectorized group-by with a
monoid, finalize shapes the result. Runs over the numpy states a run
returns (the reference's map-reduce is a host phase too).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from janusgraph_tpu_torch.olap.vertex_program import Combiner


class MapReduce:
    """Subclass hooks: map() (required) and optionally finalize(), or
    override execute() for reductions that are no group-by.

    memory_key — where the result lands in a computer's result memory
    reduce_op  — Combiner monoid of the default group-by reduce
    """

    memory_key: str = "mapreduce"
    reduce_op: str = Combiner.SUM

    def map(self, states: Dict[str, np.ndarray], csr, xp) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, values) arrays of equal length (typically one entry per
        vertex; masked subsets allowed); ``xp`` is numpy."""
        raise NotImplementedError

    def finalize(self, result: Dict) -> object:
        return result

    def execute(self, states: Dict[str, np.ndarray], csr) -> object:
        keys, values = self.map(states, csr, np)
        keys = np.asarray(keys)
        values = np.asarray(values, dtype=np.float64)
        uniq, inverse = np.unique(keys, return_inverse=True)
        if self.reduce_op == Combiner.SUM:
            red = np.bincount(inverse, weights=values, minlength=len(uniq))
        elif self.reduce_op == Combiner.MIN:
            red = np.full(len(uniq), np.inf)
            np.minimum.at(red, inverse, values)
        else:
            red = np.full(len(uniq), -np.inf)
            np.maximum.at(red, inverse, values)
        return self.finalize({k: v for k, v in zip(uniq.tolist(), red.tolist())})


def run_map_reduce(mr: MapReduce, states: Dict[str, np.ndarray], csr) -> object:
    return mr.execute(states, csr)


class ClusterCountMapReduce(MapReduce):
    """Distinct cluster count and sizes from a label-valued state array
    (TinkerPop's ClusterCountMapReduce / ClusterPopulationMapReduce, used
    with PeerPressure and CC)."""

    memory_key = "clusterCount"

    def __init__(self, state_key: str = "cluster"):
        self.state_key = state_key

    def map(self, states, csr, xp):
        labels = xp.asarray(states[self.state_key])
        return labels, xp.ones(len(labels))

    def finalize(self, result):
        return {"count": len(result), "sizes": result}


class StatsMapReduce(MapReduce):
    """min/max/mean/sum over one state array."""

    memory_key = "stats"

    def __init__(self, state_key: str):
        self.state_key = state_key

    def execute(self, states, csr):
        v = np.asarray(states[self.state_key], dtype=np.float64)
        return {
            "min": float(v.min()),
            "max": float(v.max()),
            "mean": float(v.mean()),
            "sum": float(v.sum()),
            "count": int(len(v)),
        }


class TopKMapReduce(MapReduce):
    """Top-k vertices by a state value, as (vertex_id, value) pairs."""

    memory_key = "topK"

    def __init__(self, state_key: str, k: int = 10):
        self.state_key = state_key
        self.k = k

    def execute(self, states, csr):
        v = np.asarray(states[self.state_key], dtype=np.float64)
        k = min(self.k, len(v))
        idx = np.argpartition(-v, k - 1)[:k] if k else np.empty(0, dtype=int)
        idx = idx[np.argsort(-v[idx])]
        return [(int(csr.vertex_ids[i]), float(v[i])) for i in idx]
