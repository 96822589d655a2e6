"""The port's option registry held to the JAX package's.

For every option the port registers, its type, default and mutability
equal the reference's ``REGISTRY`` entry, except the differences listed
here by name: two defaults the port changes on purpose (ROADMAP
"Deliberate differences") and the values the port refuses, which raise
naming their ROADMAP item. The mutability check holds the repair of five
options the port once declared MASKABLE where the reference's
``ConfigNamespace.option`` makes them LOCAL. Exact equality: these are
names, types and values.
"""

import pytest

from janusgraph_tpu.core import config as ref_config
from janusgraph_tpu.exceptions import ConfigurationError as RefConfigurationError
from janusgraph_tpu_torch.core import config
from janusgraph_tpu_torch.exceptions import ConfigurationError

#: defaults the port changes on purpose: path -> (reference, port)
DEFAULT_DIFFERENCES = {
    "computer.strategy": ("auto", "segsum"),
    "computer.frontier-cc-min-edges": (1 << 20, 1 << 30),
}

#: values the reference accepts and the port refuses, with the item named
REFUSED = [
    ("storage.backend", "sharded", "Queue A #5.5"),
    ("storage.backend", "remote", "Queue A #5.5"),
    ("computer.executor", "sharded", "Queue A #4"),
]

#: the options the port once took with the wrong mutability
REPAIRED_LOCAL = (
    "computer.delta-snapshot-path",
    "metrics.enabled",
    "metrics.merge-stores",
    "metrics.prefix",
    "metrics.csv-directory",
)


@pytest.mark.parametrize("path", sorted(config.REGISTRY))
def test_option_matches_the_reference(path):
    ours = config.REGISTRY[path]
    ref = ref_config.REGISTRY[path]
    assert ours.datatype is ref.datatype
    assert ours.mutability.name == ref.mutability.name
    if path in DEFAULT_DIFFERENCES:
        assert (ref.default, ours.default) == DEFAULT_DIFFERENCES[path]
    else:
        assert ours.default == ref.default


@pytest.mark.parametrize("path", REPAIRED_LOCAL)
def test_repaired_options_are_local(path):
    assert config.REGISTRY[path].mutability is config.Mutability.LOCAL
    assert ref_config.REGISTRY[path].mutability is ref_config.Mutability.LOCAL


@pytest.mark.parametrize("path,value,item", REFUSED)
def test_refused_values_name_their_item(path, value, item):
    ref_config.REGISTRY[path].check(value)
    with pytest.raises(ConfigurationError, match=item):
        config.GraphConfiguration({path: value})


def test_a_local_option_never_reads_the_stored_value():
    """A LOCAL option takes its local value or its default, whatever the
    cluster's stored config holds (a MASKABLE one would read it)."""

    class Stored:
        def get_global_config(self, name):
            return b'"/stored/path"' if name == "computer.delta-snapshot-path" else None

        def set_global_config(self, name, value):
            raise AssertionError("nothing to store")

    cfg = config.GraphConfiguration({}, backend=Stored())
    assert cfg.get("computer.delta-snapshot-path") == ""
    ref_cfg = ref_config.GraphConfiguration({}, backend=Stored())
    assert ref_cfg.get("computer.delta-snapshot-path") == ""


#: the durable logs' options (the log bus, the WAL and its recovery, the
#: CDC log, the management broadcast, the instance registry)
LOG_OPTIONS = (
    "log.num-buckets", "log.send-batch-size", "log.read-lag-ms", "log.read-interval-ms",
    "log.send-delay-ms", "log.ttl-seconds", "log.slice-granularity-ms", "tx.log-tx",
    "tx.max-commit-time-ms", "tx.recover-on-open", "storage.cdc.dir",
    "storage.cdc.segment-records", "storage.cdc.retention-segments",
    "schema.eviction-ack-timeout-ms", "schema.eviction-ack-poll-ms", "graph.timestamps",
    "graph.unique-instance-id", "graph.unique-instance-id-suffix",
    "graph.use-hostname-for-unique-instance-id", "graph.replace-instance-if-exists",
)


def test_the_logs_options_are_registered_and_validated_as_the_reference():
    """Every option the reference honours for the logs is registered (the
    parametrized case above holds its type, default and mutability), and a
    value the reference's validator refuses is refused too."""
    assert set(LOG_OPTIONS) <= set(config.REGISTRY)
    for path, bad in (("storage.cdc.segment-records", 1000), ("log.num-buckets", 0),
                      ("graph.timestamps", "pico"), ("log.send-delay-ms", -1.0)):
        with pytest.raises(RefConfigurationError):
            ref_config.REGISTRY[path].check(bad)
        with pytest.raises(ConfigurationError):
            config.GraphConfiguration({path: bad})
