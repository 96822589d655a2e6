"""The OLAP layer: CSR snapshots, the graph computer, its executors and
programs.

The package's names load on first use (PEP 562), so a process that needs
only the scan (``olap.csr``, as the distributed loader's workers do) does
not import ``torch``: ``from janusgraph_tpu_torch.olap import GPUExecutor``
imports ``olap.gpu_executor`` then, and ``olap.<submodule>`` imports that
submodule.
"""

import importlib

#: each exported name -> the submodule that defines it
_EXPORTS = {
    **dict.fromkeys(("ComputerResult", "GraphComputer", "run_on", "write_back"), "computer"),
    **dict.fromkeys(("CSRGraph", "channel_edges", "csr_from_arrays", "csr_from_edges",
                     "load_csr", "load_csr_snapshot"), "csr"),
    "FrontierEngine": "frontier",
    **dict.fromkeys(("LDBC_SF_SIZES", "ldbc_sf_csr", "ldbc_snb_csr", "ldbc_snb_edges",
                     "rmat_csr", "rmat_edges", "twitter_csr", "twitter_edges"), "generators"),
    **dict.fromkeys(("FulgoraAnalogueComputer", "measure_fulgora_baseline"),
                    "fulgora_baseline"),
    "GPUExecutor": "gpu_executor",
    **dict.fromkeys(("ClusterCountMapReduce", "MapReduce", "StatsMapReduce", "TopKMapReduce",
                     "run_map_reduce"), "mapreduce"),
    **dict.fromkeys(("Combiner", "EdgeChannel", "EdgeTransform", "Memory", "VertexProgram"),
                    "vertex_program"),
    "DegreeCountProgram": "programs.degree",
    **dict.fromkeys(("OLAPTraversalProgram", "TraversalStep", "build_olap_traversal"),
                    "programs.olap_traversal"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    else:
        try:
            value = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
