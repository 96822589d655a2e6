"""Multi-graph management: graph registry + dynamic configured graphs —
the port's copy of ``janusgraph_tpu/server/manager.py``.

Capability parity with the reference
(reference: graphdb/management/JanusGraphManager.java:49 — instance-wide
registries of named graphs and traversal sources, lazily opened through a
GraphSupplier; core/ConfiguredGraphFactory.java:57 — create/open graphs by
name from configurations stored in a special management graph, so every
server node agrees on the set of dynamic graphs).

The configuration-management graph stores one vertex per dynamic graph,
label "configuration", properties graph_name + config_json — the analogue of
ConfigurationManagementGraph's property-keyed config vertices.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional

from janusgraph_tpu_torch.exceptions import ConfigurationError


class JanusGraphManager:
    """Process-wide registry of named graphs + traversal sources."""

    _instance: Optional["JanusGraphManager"] = None

    def __init__(self):
        self._graphs: Dict[str, object] = {}
        self._suppliers: Dict[str, Callable[[], object]] = {}
        self._lock = threading.RLock()

    @classmethod
    def get_instance(cls) -> "JanusGraphManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # ------------------------------------------------------------- registry
    def put_graph(self, name: str, graph) -> None:
        with self._lock:
            self._graphs[name] = graph

    def get_graph(self, name: str):
        with self._lock:
            g = self._graphs.get(name)
            if g is None and name in self._suppliers:
                g = self._suppliers[name]()
                self._graphs[name] = g
            return g

    def put_graph_supplier(self, name: str, supplier: Callable[[], object]) -> None:
        """Lazily-opened graph (reference: JanusGraphManager lazy open via
        GraphSupplier)."""
        with self._lock:
            self._suppliers[name] = supplier

    def remove_graph(self, name: str):
        with self._lock:
            self._suppliers.pop(name, None)
            return self._graphs.pop(name, None)

    def graph_names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._graphs) | set(self._suppliers))

    def traversal_source(self, name: str):
        """`g_<graphname>` style traversal source lookup."""
        g = self.get_graph(name)
        return None if g is None else g.traversal()

    def close_all(self) -> None:
        with self._lock:
            for g in self._graphs.values():
                try:
                    g.close()
                except Exception:
                    pass
            self._graphs.clear()
            self._suppliers.clear()


class ConfiguredGraphFactory:
    """Create/open dynamic graphs from stored configurations.

    (reference: core/ConfiguredGraphFactory.java:57 + the
    ConfigurationManagementGraph it reads from)
    """

    LABEL = "configuration"
    NAME_KEY = "graph_name"
    CONFIG_KEY = "config_json"
    TEMPLATE_NAME = "__template__"

    def __init__(self, management_graph, manager: Optional[JanusGraphManager] = None):
        self.management_graph = management_graph
        self.manager = manager or JanusGraphManager.get_instance()
        self._ensure_schema()

    def _ensure_schema(self) -> None:
        mgmt = self.management_graph.management()
        if self.management_graph.schema_cache.get_by_name(self.NAME_KEY) is None:
            mgmt.make_property_key(self.NAME_KEY, str)
            mgmt.make_property_key(self.CONFIG_KEY, str)
            mgmt.make_vertex_label(self.LABEL)
            mgmt.build_composite_index(
                f"by_{self.NAME_KEY}", [self.NAME_KEY], unique=True
            )

    # --------------------------------------------------------------- config
    def _find(self, tx, name: str):
        hits = (
            tx.traversal().V().has(self.NAME_KEY, name).to_list()
            if hasattr(tx, "traversal")
            else []
        )
        return hits[0] if hits else None

    def create_configuration(self, config: dict) -> None:
        name = config.get("graph.graphname")
        if not name:
            raise ConfigurationError("config must set graph.graphname")
        tx = self.management_graph.new_transaction(read_only=False)
        src = self.management_graph.traversal()
        existing = src.V().has(self.NAME_KEY, name).to_list()
        if existing:
            src.rollback()
            raise ConfigurationError(f"configuration for {name!r} already exists")
        v = src.add_v(self.LABEL)
        v.property(self.NAME_KEY, name)
        v.property(self.CONFIG_KEY, json.dumps(config))
        src.commit()
        tx.rollback()

    def create_template_configuration(self, config: dict) -> None:
        cfg = dict(config)
        cfg["graph.graphname"] = self.TEMPLATE_NAME
        try:
            self.create_configuration(cfg)
        except ConfigurationError:
            raise ConfigurationError("template configuration already exists")

    def get_configuration(self, name: str) -> Optional[dict]:
        src = self.management_graph.traversal()
        hits = src.V().has(self.NAME_KEY, name).values(self.CONFIG_KEY).to_list()
        src.rollback()
        if not hits:
            return None
        return json.loads(hits[0])

    def list_configurations(self) -> List[str]:
        src = self.management_graph.traversal()
        names = src.V().has_label(self.LABEL).values(self.NAME_KEY).to_list()
        src.rollback()
        return sorted(n for n in names if n != self.TEMPLATE_NAME)

    def remove_configuration(self, name: str) -> None:
        src = self.management_graph.traversal()
        for v in src.V().has(self.NAME_KEY, name).to_list():
            v.remove()
        src.commit()

    # ---------------------------------------------------------------- graph
    def _open_from_config(self, config: dict):
        from janusgraph_tpu_torch.core.graph import open_graph

        cfg = {
            k: v for k, v in config.items()
            if k not in ("graph.graphname",)
        }
        return open_graph(cfg)

    def create(self, name: str):
        """Instantiate from the template configuration (reference:
        ConfiguredGraphFactory.create)."""
        template = self.get_configuration(self.TEMPLATE_NAME)
        if template is None:
            raise ConfigurationError("no template configuration exists")
        cfg = dict(template)
        cfg["graph.graphname"] = name
        self.create_configuration(cfg)
        return self.open(name)

    def open(self, name: str):
        g = self.manager.get_graph(name)
        if g is not None:
            return g
        config = self.get_configuration(name)
        if config is None:
            raise ConfigurationError(f"no configuration for graph {name!r}")
        g = self._open_from_config(config)
        self.manager.put_graph(name, g)
        return g

    def drop(self, name: str) -> None:
        g = self.manager.remove_graph(name)
        if g is not None:
            from janusgraph_tpu_torch.core.graph import drop_graph

            # one drop implementation: storage AND the shared mixed-index
            # providers are destroyed together (stale index hits otherwise)
            drop_graph(g)
        self.remove_configuration(name)

    def graph_names(self) -> List[str]:
        return self.list_configurations()
