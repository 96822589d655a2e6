"""The port's option registry held to the JAX package's.

For every option the port registers, its type, default and mutability
equal the reference's ``REGISTRY`` entry, except the differences listed
here by name: two defaults the port changes on purpose (ROADMAP
"Deliberate differences"). The value the port once refused,
``cluster.num-processes`` above 1, is taken since the multi-process
transport was ported, and no refusal or option text names its item. The mutability check holds the repair of five
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

#: values the port once refused, with the item that refused them: taken
#: now as the reference takes them
REFUSED = [
    ("cluster.num-processes", 2, "Queue A #4b"),
]

#: options the port accepts since the fault injector, the sharded store,
#: the remote index and the fleet (whose replica and follower-lag faults
#: it consumes) were ported, with a value each
ACCEPTED = [
    ("storage.backend", "sharded"),
    ("storage.sharded-nodes", 5),
    ("index.search.backend", "remote"),
    ("index.search.hostname", "10.0.0.7"),
    ("index.search.port", 8000),
    ("index.search.pool-size", 2),
    ("index.search.retry-time-ms", 500.0),
    ("index.search.pipeline", False),
    ("storage.faults.enabled", True),
    ("storage.faults.seed", 7),
    ("storage.faults.read-error-rate", 0.01),
    ("storage.faults.write-error-rate", 0.01),
    ("storage.faults.latency-ms", 2.0),
    ("storage.faults.latency-rate", 0.1),
    ("storage.faults.overload-at", 3),
    ("storage.faults.overload-ops", 4),
    ("storage.faults.overload-latency-ms", 1.0),
    ("storage.faults.torn-mutation-at", 9),
    ("storage.faults.lock-expiry-at", 2),
    ("storage.faults.scan-kill-at", 1),
    ("storage.faults.scan-kill-after-rows", 3),
    ("storage.faults.preempt-superstep", 3),
    ("storage.faults.cdc-torn-at", 2),
    ("storage.faults.stall-lock-at", 1),
    ("storage.faults.stall-lock-ms", 1.0),
    ("storage.faults.wedge-thread-at", 1),
    ("storage.faults.stores", "edgestore"),
    ("storage.faults.replica-kill-at", 1),
    ("storage.faults.replica-restart-at", 1),
    ("storage.faults.replica-partition-at", 1),
    ("storage.faults.replica-partition-ops", 1),
    ("storage.faults.replica-target", 1),
    ("storage.faults.follower-lag-at", 1),
    ("storage.faults.follower-lag-pulls", 1),
    # the sharded executor's and the kinds it consumes
    ("storage.faults.shard-preempt-superstep", 3),
    ("storage.faults.shard-preempt-shard", 1),
    ("storage.faults.shard-collective-timeout-at", 1),
    ("storage.faults.shard-halo-drop-at", 1),
    ("storage.faults.shard-straggler-ms", 1.0),
    ("storage.faults.shard-straggler-rate", 0.5),
    ("computer.executor", "sharded"),
    ("computer.exchange", "blocked"),
    ("computer.agg", "segment"),
    ("computer.sharded-auto", False),
    ("computer.shard-measure", False),
    ("computer.shard-checkpoint-path", "/tmp/shards"),
    ("computer.shard-checkpoint-every", 2),
    ("computer.shard-checkpoint-shards", 4),
    ("cluster.max-partitions", 4),
    ("cluster.coordinator-address", "localhost:1234"),
    ("cluster.num-processes", 1),
    ("cluster.process-id", 0),
]

#: the cluster option whose consumer (a run of more than one process) was
#: the last refused, with its item: no text of the registry names it now
STILL_REFUSED = [
    ("cluster.num-processes", 2, "Queue A #4b"),
]

#: the options the port once took with the wrong mutability
REPAIRED_LOCAL = (
    "computer.delta-snapshot-path",
    "metrics.enabled",
    "metrics.merge-stores",
    "metrics.prefix",
    "metrics.csv-directory",
)


def _refusal_texts():
    """The texts the registry could refuse with. Every option of the
    reference is registered and no value is refused, so the module keeps
    no refusal table: only the option descriptions remain to search."""
    assert not hasattr(config, "_NOT_PORTED") and not hasattr(config, "_REFUSED_VALUES")
    return [opt.description for opt in config.REGISTRY.values()]


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
    """The value is taken as the reference takes it, and no refusal of a
    value is left for its path."""
    ref_config.REGISTRY[path].check(value)
    assert config.REGISTRY[path].check(value) == value
    assert config.GraphConfiguration({path: value}).get(path) == value
    assert not hasattr(config, "_REFUSED_VALUES")


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


#: the remote store's, placement's and id authority's options, each with a
#: value the reference's verifier refuses
REMOTE_BAD_VALUES = [
    ("storage.connection-pool-size", 0), ("storage.remote.connect-timeout-ms", 0.0),
    ("storage.remote.parallel-slice-factor", 0), ("storage.remote.pipeline-connections", 0),
    ("storage.remote.pipeline-depth", 0), ("storage.remote.pipeline-max-batch", 0),
    ("storage.remote.pipeline-multi-chunk", 0), ("storage.remote.pipeline-stall-ms", -1.0),
    ("storage.remote.pipeline-coalesce-us", -1.0), ("storage.breaker.failure-threshold", 0),
    ("storage.breaker.reset-ms", 0.0), ("storage.breaker.half-open-probes", 0),
    ("ids.placement", "hashed"), ("ids.authority.conflict-avoidance-mode", "tagged"),
    ("ids.authority.conflict-avoidance-tag", -1),
    ("ids.authority.conflict-avoidance-tag-bits", 0),
    ("ids.authority.conflict-avoidance-tag-bits", 17),
]


@pytest.mark.parametrize("path,bad", REMOTE_BAD_VALUES)
def test_remote_options_refuse_what_the_reference_refuses(path, bad):
    """The remote store's options are registered and a value the
    reference's verifier refuses is refused too (the parametrized case
    above holds their types, defaults and mutability)."""
    with pytest.raises(RefConfigurationError):
        ref_config.REGISTRY[path].check(bad)
    with pytest.raises(ConfigurationError):
        config.GraphConfiguration({path: bad})


@pytest.mark.parametrize("path,value", ACCEPTED)
def test_ported_options_are_accepted_as_the_reference_takes_them(path, value):
    ref_config.REGISTRY[path].check(value)
    assert config.GraphConfiguration({path: value}).get(path) == value


@pytest.mark.parametrize("path,value,item", STILL_REFUSED)
def test_fault_options_without_a_consumer_name_their_item(path, value, item):
    """The option's consumer is ported: no refusal and no option
    description names its item any more."""
    ref_config.REGISTRY[path].check(value)
    assert config.GraphConfiguration({path: value}).get(path) == value
    texts = _refusal_texts()
    texts += [opt.description for opt in config.REGISTRY.values()]
    assert not [t for t in texts if item in t or "#4b" in t]


def test_no_refusal_cites_the_ported_slice():
    texts = _refusal_texts()
    assert not [t for t in texts if "#5.5b" in t]


#: the query server's, its driver's and its observability plane's options,
#: with a value each the reference's verifier takes
SERVER_ACCEPTED = [
    ("server.port", 0),
    ("server.request-timeout-s", 30.0),
    ("server.auto-commit", False),
    ("server.admission.enabled", False),
    ("server.admission.initial-limit", 8),
    ("server.deadline.max-ms", 900_000.0),
    ("server.watchdog-stall-s", 5.0),
    ("metrics.history-interval-s", 0.5),
    ("metrics.slo-page-burn", 10.0),
    ("metrics.profile-hz", 50.0),
    ("metrics.bundle-retention", 3),
    ("metrics.stream-depth", 64),
    ("computer.price-book-path", "/tmp/book.json"),
    ("driver.retry-budget-capacity", 5.0),
    ("driver.ws-multiplex", False),
]

#: the fleet's options, accepted since the fleet was ported
FLEET_OPTIONS = [
    ("server.fleet.replicas", 2),
    ("server.fleet.replica-name", "r1"),
    ("metrics.fleet-retention", 10),
    ("metrics.fleet-outlier-factor", 3.0),
]


@pytest.mark.parametrize("path,value", SERVER_ACCEPTED)
def test_server_options_are_accepted_as_the_reference_takes_them(path, value):
    ref_config.REGISTRY[path].check(value)
    assert config.GraphConfiguration({path: value}).get(path) == value


@pytest.mark.parametrize("path,value", FLEET_OPTIONS)
def test_fleet_options_name_their_item(path, value):
    """The fleet's options are honoured now: accepted as the reference
    takes them, and no refusal names the fleet's item."""
    ref_config.REGISTRY[path].check(value)
    assert config.GraphConfiguration({path: value}).get(path) == value
    texts = _refusal_texts()
    assert not [t for t in texts if "#5.6b" in t]


def test_no_refusal_cites_the_server_slice():
    """No refusal names item #5.6 of the queue or its fleet half #5.6b."""
    texts = _refusal_texts()
    assert not [t for t in texts if "#5.6 " in t or t.endswith("#5.6") or "#5.6b" in t]
