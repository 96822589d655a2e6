"""janusgraph_tpu_torch — janusgraph_tpu on PyTorch and CUDA.

A second package beside ``janusgraph_tpu`` (the JAX reference). It imports
``torch`` and numpy only, never ``jax`` and nothing of ``janusgraph_tpu``:
every host-side helper it needs (the native host library, the storage read
path, the codecs, the segment-sum plan, the ELL pack) is its own copy, so
the two packages can be held against each other on the same inputs.

``open_graph`` opens a stored graph (in memory); ``graph.traversal()`` is
the Gremlin entry point over it, ``graph.compute()`` the OLAP one, and
``janusgraph_tpu_torch.olap.run_on`` the one over a CSR snapshot.
``export_graphson``/``import_graphson`` write and read a graph as
line-delimited GraphSON (``graph.io()`` also speaks GraphML).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise.
"""

from janusgraph_tpu_torch.core.graph import open_graph  # noqa: F401
from janusgraph_tpu_torch.device import resolve_device  # noqa: F401


def export_graphson(graph, path_or_file):
    """Export a graph to line-delimited GraphSON (TinkerPop io() analogue)."""
    from janusgraph_tpu_torch.core.io import export_graphson as _exp

    return _exp(graph, path_or_file)


def import_graphson(graph, path_or_file, batch_size=1000):
    """Import a line-delimited GraphSON export (ids remapped)."""
    from janusgraph_tpu_torch.core.io import import_graphson as _imp

    return _imp(graph, path_or_file, batch_size=batch_size)
