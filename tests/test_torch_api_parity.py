"""Every public name of the JAX package has a counterpart in the port.

For each module of ``janusgraph_tpu/``, its public names — top-level defs
and classes, the public methods of each class, module-level assignments
and ``__all__`` — are read from the source by AST (this test never imports
the reference) and looked up on the port's module of the same path
(``tpu_executor.py`` is ``gpu_executor.py``, ``native/__init__.py`` is
``native.py``): the name must exist there (``hasattr``), and a class's
method on the port's class. The rest sit in ``DIFFERENCES`` with the
port's counterpart, where it has one under another name, and the reason;
the same table stands in ROADMAP.md's "Deliberate differences". The last
case drives the names the port took over last against the reference's
(only it imports the reference).
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "janusgraph_tpu"

#: reference module path -> the port's, where the file is named otherwise
MODULE_RENAMES = {
    "olap/tpu_executor.py": "olap/gpu_executor.py",
    "native/__init__.py": "native.py",
}

#: (reference module, name or Class.method) -> (the port's counterpart or
#: None, reason)
DIFFERENCES = {
    ("olap/cpu_executor.py", "*"): (
        None,
        "the reference's numpy oracle executor; the port's \"cpu\" executor "
        "is GPUExecutor(device=\"cpu\"), the plain PyTorch versions, and the "
        "tests hold it to the reference's CPUExecutor (Queue C #1)",
    ),
    ("olap/tpu_executor.py", "TPUExecutor"): (
        "GPUExecutor",
        "renamed for the device it drives; every public method is the "
        "reference's",
    ),
    ("olap/kernels.py", "pallas_sorted_segment_sum"): (
        "sorted_segment_sum",
        "the hand-written CUDA kernel (csrc/segsum.cu) on the same "
        "segment-sum plan, named for what it computes, not for Pallas",
    ),
    ("olap/kernels.py", "ELLPack.device_put"): (
        None,
        "a JAX placement hook (jax.device_put of the pack's arrays); the "
        "port's executor moves each array to the card lazily on first read",
    ),
    ("olap/kernels.py", "HybridPack.device_put"): (
        None,
        "a JAX placement hook, as ELLPack.device_put",
    ),
    ("olap/kernels.py", "HybridPackView"): (
        None,
        "a JAX tracing facade (the hybrid pack's arrays as a pytree inside "
        "jit); the port traces nothing",
    ),
    ("parallel/compat.py", "shard_map"): (
        None,
        "JAX's shard_map across JAX versions; the port's Mesh runs each "
        "device group's body itself (compat.lockstep)",
    ),
    ("parallel/compat.py", "resolve_shard_map"): (
        None,
        "picks JAX's shard_map entry point, as shard_map",
    ),
    ("observability/profiler.py", "harvest_cost"): (
        None,
        "harvests XLA's cost_analysis() of a lowered superstep; the port "
        "lowers nothing, so every record takes the reference's own "
        "fallback, estimate_superstep_cost",
    ),
    ("analysis/tracing.py", "JIT_CALL_NAMES"): (
        "CAPTURE_CALL_NAMES",
        "the trace rules start at CUDA-graph capture, not at jax.jit",
    ),
    ("cli.py", "cmd_bench"): (
        None,
        "runs the reference's bench.py, which imports JAX; the port's bench "
        "subcommand refuses with exit code 2 until the port has its own "
        "benchmark",
    ),
}


def _public(name):
    return not name.startswith("_")


def reference_names(path):
    """(name, method or None) for every public name of one module."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out.append((node.name, None))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.append((node.name, None))
            out.extend(
                (node.name, b.name) for b in node.body
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(b.name)
            )
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    out.extend((n, None) for n in ast.literal_eval(node.value))
                elif _public(t.id):
                    out.append((t.id, None))
    return list(dict.fromkeys(out))


MODULES = sorted(
    str(p.relative_to(REFERENCE)) for p in REFERENCE.rglob("*.py")
    if "__pycache__" not in p.parts
)


def port_module(rel):
    rel = MODULE_RENAMES.get(rel, rel)
    name = "janusgraph_tpu_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def test_the_reference_has_modules_to_hold():
    assert len(MODULES) > 100 and "observability/benchdiff.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    if (rel, "*") in DIFFERENCES:
        return
    mod = port_module(rel)
    missing = []
    for name, method in reference_names(REFERENCE / rel):
        label = f"{name}.{method}" if method else name
        counterpart = name
        if (rel, label) in DIFFERENCES:
            counterpart = DIFFERENCES[(rel, label)][0]
            if counterpart is None or method:
                continue
        elif (rel, name) in DIFFERENCES:
            counterpart = DIFFERENCES[(rel, name)][0]
            if counterpart is None:
                continue
        if not hasattr(mod, counterpart):
            missing.append(label)
        elif method and not hasattr(getattr(mod, counterpart), method):
            missing.append(label)
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("key", sorted(DIFFERENCES))
def test_each_difference_is_still_one(key):
    """A row names a reference name the port lacks under that name, and a
    renamed counterpart exists in the port."""
    rel, label = key
    assert (REFERENCE / rel).is_file()
    if label == "*":
        with pytest.raises(ModuleNotFoundError):
            port_module(rel)
        return
    name, _, method = label.partition(".")
    assert (name, method or None) in reference_names(REFERENCE / rel)
    mod = port_module(rel)
    owner = getattr(mod, name, None)
    assert owner is None or (method and not hasattr(owner, method))
    counterpart = DIFFERENCES[key][0]
    if counterpart is not None:
        assert hasattr(mod, counterpart)


def test_roadmap_lists_the_differences():
    """ROADMAP.md's "Deliberate differences" holds the same table, row for
    row."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("## Deliberate differences"):]
    for (rel, label), (counterpart, reason) in DIFFERENCES.items():
        row = f"| `{rel}` | `{label}` | {f'`{counterpart}`' if counterpart else '—'} | {reason} |"
        assert row in section, row


def test_the_last_names_behave_as_the_references():
    """drop_graph, the base error's reference name, the single-device CSR's
    shard interface, Memory.reduce_in, EdgeSerializer.get_bounds,
    SchemaCache.data_type_for and the executor's write_back, each on the
    same inputs as the reference's."""
    import numpy as np

    import janusgraph_tpu
    import janusgraph_tpu_torch
    from janusgraph_tpu.core import codecs as ref_codecs
    from janusgraph_tpu.olap.csr import csr_from_edges as ref_csr_from_edges
    from janusgraph_tpu.olap.vertex_program import Memory as RefMemory
    from janusgraph_tpu_torch import exceptions
    from janusgraph_tpu_torch.core import codecs
    from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges
    from janusgraph_tpu_torch.olap.csr import load_csr
    from janusgraph_tpu_torch.olap.vertex_program import Memory

    assert exceptions.JanusGraphTPUError is exceptions.JanusGraphTorchError
    assert issubclass(exceptions.TemporaryBackendError, exceptions.JanusGraphTPUError)

    src, dst = np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3])
    ours, ref = csr_from_edges(4, src, dst), ref_csr_from_edges(4, src, dst)
    assert (ours.local_num_vertices, ours.global_offset) == (ref.local_num_vertices,
                                                             ref.global_offset)
    assert np.array_equal(ours.active, ref.active)

    mem, ref_mem = Memory(), RefMemory()
    for m in (mem, ref_mem):
        m.reduce_in({"delta": ("sum", np.float32(0.25)), "n": ("max", 3)})
    assert (mem.values, mem.superstep) == (ref_mem.values, ref_mem.superstep)

    graphs = []
    for opener in (janusgraph_tpu.open_graph, janusgraph_tpu_torch.open_graph):
        g = opener({"computer.executor": "cpu"})
        tx = g.new_transaction()
        tx.add_vertex(name="a", age=3)
        tx.commit()
        graphs.append(g)
    ref_g, g = graphs
    for cat in codecs.RelationCategory:
        for system in (False, True):
            a = g.edge_serializer.get_bounds(cat, system)
            b = ref_g.edge_serializer.get_bounds(ref_codecs.RelationCategory(int(cat)), system)
            assert (a.start, a.end) == (b.start, b.end)
    for key in ("name", "age"):
        a = g.schema_cache.data_type_for(g.serializer, g.schema_cache.get_by_name(key))
        b = ref_g.schema_cache.data_type_for(ref_g.serializer,
                                             ref_g.schema_cache.get_by_name(key))
        assert a.type_id == b.type_id

    csr = load_csr(g)
    GPUExecutor(csr, device="cpu").write_back(g, {"score": np.array([0.5])})
    tx = g.new_transaction()
    assert tx.get_vertex(int(csr.vertex_ids[0])).value("score") == 0.5
    tx.rollback()

    ref_g.close()
    janusgraph_tpu_torch.drop_graph(g)
    assert not g.backend.manager.exists()
