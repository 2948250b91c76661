"""The port's ``PartitionPlan``, ``propose_starts`` and the routing-table
audit, held case by case against the JAX package's (``repro.core.partition``,
``repro.core.sharded``; the cases of ``tests/core/test_partition_plan.py``).

Tolerance: exact. The same spec parses to the same plan field for field, the
same misuse raises the same typed error in both packages, and
``propose_starts`` returns ``array_equal`` boundaries.
"""
import numpy as np
import pytest
import torch

from repro.core.errors import EngineConfigError as JaxConfigError
from repro.core.partition import PartitionPlan as JaxPlan
from repro.core.partition import propose_starts as jax_propose_starts
from repro.core.sharded import ShardLayout as JaxLayout
from repro.core.sharded import ShardRoutingTable as JaxRoutingTable
from repro_torch import knn
from repro_torch.core.errors import EngineConfigError, EpochError, QueryError
from repro_torch.core.partition import PartitionPlan, propose_starts
from repro_torch.core.sharded import ShardLayout, ShardRoutingTable

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs many small tensor ops; under a parallel test
    run (several workers on a few cores) torch's intra-op thread pool makes
    each one wait on oversubscribed threads, 30x slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = ("shards", "ranges", "replication", "policy")

PARSE_OK = [
    "shards=4",
    "shards=4,replicate=auto:2,ranges=auto",
    "shards=3,ranges=0:100:700",
    "ranges=0:10:20,policy=least_outstanding",
    "shards=2,replicate=0:3",
    "shards=2,ranges=equal",
    "",
]


@pytest.mark.parametrize("spec", PARSE_OK, ids=[s or "<empty>" for s in PARSE_OK])
def test_parse_ok_matches_jax(spec):
    mine, theirs = PartitionPlan.parse(spec), JaxPlan.parse(spec)
    for field in FIELDS:
        assert getattr(mine, field) == getattr(theirs, field), (spec, field)
    assert mine.describe() == theirs.describe()
    assert mine.replication_dict() == theirs.replication_dict()
    assert mine.auto_replicas() == theirs.auto_replicas()


PARSE_BAD = [
    "shards",                      # not key=value
    "shard=4",                     # unknown key
    "shards=4,shards=8",           # duplicate key
    "shards=x",                    # not an int
    "shards=0",                    # non-positive
    "ranges=5:10",                 # must start at 0
    "ranges=0:10:10",              # not strictly increasing
    "ranges=0:a",                  # not ints
    "replicate=auto:0",            # auto wants >= 1 extras
    "replicate=3",                 # missing :R
    "replicate=0:-1",              # negative count
    "policy=fastest",              # unknown policy
    "shards=2,ranges=0:10:20",     # shard count vs boundary count mismatch
]


@pytest.mark.parametrize("spec", PARSE_BAD)
def test_parse_bad_is_typed_as_in_jax(spec):
    with pytest.raises(JaxConfigError) as theirs:
        JaxPlan.parse(spec)
    with pytest.raises(EngineConfigError) as mine:
        PartitionPlan.parse(spec)
    assert str(mine.value) == str(theirs.value)


def test_engine_config_error_is_value_error():
    assert issubclass(EngineConfigError, ValueError)
    with pytest.raises(ValueError):
        PartitionPlan.parse("shards=0")


def test_plan_infers_shards_from_ranges():
    plan = PartitionPlan(ranges=(0, 5, 11))
    assert plan.shards == JaxPlan(ranges=(0, 5, 11)).shards == 3
    assert plan.describe() == JaxPlan(ranges=(0, 5, 11)).describe()
    assert plan.describe()["ranges"] == [0, 5, 11]


def test_plan_replication_dict_and_auto():
    for plan_cls in (PartitionPlan, JaxPlan):
        assert plan_cls(replication={1: 2, 0: 1}).replication_dict() == {0: 1, 1: 2}
        auto = plan_cls(replication=("auto", 2))
        assert auto.replication_dict() is None and auto.auto_replicas() == 2
        assert plan_cls().auto_replicas() == 0
        assert plan_cls.resolve(None, replication={}).replication == ()
        assert plan_cls.resolve(None).replication is None


def test_resolve_rejects_plan_plus_legacy_kwargs():
    plan = PartitionPlan(shards=2)
    with pytest.raises(EngineConfigError):
        PartitionPlan.resolve(plan, shards=2)
    with pytest.raises(EngineConfigError):
        PartitionPlan.resolve("shards=2", replication={0: 1})
    assert PartitionPlan.resolve(None, shards=2).shards == 2
    assert PartitionPlan.resolve("shards=2").shards == 2


@pytest.mark.parametrize("bad", [
    dict(shards=-1), dict(shards=1.5), dict(ranges="fastest"),
    dict(ranges=(1, 2)), dict(ranges=(0, 0)), dict(policy="nope"),
    dict(replication={-1: 1}), dict(replication={0: -2}),
    dict(shards=2, ranges=(0, 1, 2)),
])
def test_plan_constructor_bad_is_typed_as_in_jax(bad):
    with pytest.raises(JaxConfigError) as theirs:
        JaxPlan(**bad)
    with pytest.raises(EngineConfigError) as mine:
        PartitionPlan(**bad)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# propose_starts
# ---------------------------------------------------------------------------


def _skewed_head(n):
    w = np.zeros(n)
    w[:10] = 9.0
    w[10:] = 0.1
    return w


def _spike(n):
    w = np.zeros(n)
    w[7] = 1.0
    return w


@pytest.mark.parametrize("weights,shards", [
    (_skewed_head(100), 4),
    (np.zeros(100), 4),
    (np.zeros(9), 8),
    (_spike(50), 4),
    (1.0 / (1.0 + np.arange(144.0)), 3),
    (np.random.default_rng(0).random(1000), 8),
    (np.random.default_rng(1).random(37) ** 4, 5),
])
def test_propose_starts_matches_jax(weights, shards):
    mine = propose_starts(weights, shards)
    np.testing.assert_array_equal(mine, jax_propose_starts(weights, shards))
    assert mine[0] == 0 and np.all(np.diff(mine) > 0) and mine[-1] <= len(weights) - 1


def test_propose_starts_balances_weight():
    w = _skewed_head(100)
    starts = propose_starts(w, 4)
    shares = np.add.reduceat(w, starts) / w.sum()
    assert shares.max() < 0.5, (starts, shares)
    assert propose_starts(np.zeros(100), 4).tolist() == [0, 25, 50, 75]
    assert propose_starts(np.zeros(9), 8).tolist() == [0, 2, 3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize("w,s", [
    (np.full(10, -1.0), 2),      # negative weights
    (np.full(10, np.inf), 2),    # non-finite
    (np.ones(10), 11),           # more shards than vertices
    (np.ones(10), 0),            # no shards
])
def test_propose_starts_bad_is_typed_as_in_jax(w, s):
    with pytest.raises(JaxConfigError):
        jax_propose_starts(w, s)
    with pytest.raises(EngineConfigError):
        propose_starts(w, s)


def test_propose_starts_length_mismatch():
    with pytest.raises(EngineConfigError):
        propose_starts(np.ones(10), 2, n=12)


# ---------------------------------------------------------------------------
# routing table and layout, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,starts", [(100, None), (144, (0, 10, 100)), (37, (0, 1, 2, 30)),
                                      (10, (0,)), (9, None)])
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_layout_addresses_match_jax(n, starts, shards):
    if starts is not None:
        shards = len(starts)
        mine, theirs = ShardLayout.from_starts(n, starts), JaxLayout.from_starts(n, starts)
    else:
        mine, theirs = ShardLayout.equal(n, shards), JaxLayout.equal(n, shards)
    vs = np.arange(n + 1)
    np.testing.assert_array_equal(mine.owner(vs), theirs.owner(vs))
    np.testing.assert_array_equal(mine.padded_rows(vs[:-1]), theirs.padded_rows(vs[:-1]))
    np.testing.assert_array_equal(mine.widths, theirs.widths)
    assert (mine.block, mine.shard_rows, mine.is_equal) == (
        theirs.block, theirs.shard_rows, theirs.is_equal)


@pytest.mark.parametrize("policy", ["round_robin", "least_outstanding"])
def test_slot_assignment_matches_jax(policy):
    mine, theirs = ShardRoutingTable(100, 4), JaxRoutingTable(100, 4)
    np.testing.assert_array_equal(mine.set_replication({1: 2, 3: 1}),
                                  theirs.set_replication({1: 2, 3: 1}))
    rng = np.random.default_rng(3)
    for _ in range(5):
        vs = rng.integers(0, 100, size=int(rng.integers(1, 60)))
        own_m, slots_m = mine.route(vs, policy=policy)
        own_t, slots_t = theirs.route(vs, policy=policy)
        np.testing.assert_array_equal(own_m, own_t)
        np.testing.assert_array_equal(slots_m, slots_t)
        mine.record_dispatch(slots_m[: len(slots_m) // 2])
        theirs.record_dispatch(slots_t[: len(slots_t) // 2])
    np.testing.assert_array_equal(mine.outstanding, theirs.outstanding)


def test_routing_table_policies():
    rt = ShardRoutingTable(100, 4)
    rt.set_replication({1: 2})
    assert rt.num_slots == 6 and list(rt.slot_shard) == [0, 1, 2, 3, 1, 1]
    vs = np.full(30, 30, dtype=np.int64)
    own, slots = rt.route(vs, policy="round_robin")
    assert np.all(own == 1)
    assert all(int(np.sum(slots == s)) == 10 for s in (1, 4, 5))
    rt.outstanding[:] = 0
    rt.outstanding[4] = 25  # slot 4 is backed up: the water fill avoids it
    own, slots = rt.route(vs, policy="least_outstanding")
    assert np.all(np.isin(slots, (1, 4, 5)))
    assert int(np.sum(slots == 4)) < int(np.sum(slots == 1))
    with pytest.raises(QueryError):
        rt.route(vs, policy="fastest_guess")
    assert list(rt.set_replication({0: 0})) == [0, 1, 2, 3]


def test_set_replication_bad_shard_ids_typed():
    rt = ShardRoutingTable(100, 4)
    for bad in ({9: 1}, {-1: 1}, {0: -1}):
        with pytest.raises(EngineConfigError):
            rt.set_replication(bad)
        with pytest.raises(ValueError):
            rt.set_replication(bad)


def test_unknown_route_policy_typed():
    rt = ShardRoutingTable(100, 4)
    with pytest.raises(QueryError):
        rt.route(np.array([0, 50]), policy="fastest")
    with pytest.raises(QueryError):
        rt.assign_slots(np.array([0]), "no_such_policy")


def test_owner_out_of_range_typed():
    rt = ShardRoutingTable(100, 4)
    assert rt.owner(np.array([0, 99, 100])).shape == (3,)  # n is the dummy address
    for bad in (200, 101, -1):
        with pytest.raises(QueryError):
            rt.owner(np.array([bad]))


def test_layout_validation_typed():
    for bad in ((5, 10), (0, 10, 10), (0, 99, 150)):
        with pytest.raises(JaxConfigError):
            JaxLayout.from_starts(100, np.array(bad))
        with pytest.raises(EngineConfigError):
            ShardLayout.from_starts(100, np.array(bad))
    with pytest.raises(EngineConfigError):
        ShardRoutingTable(100, 2, starts=np.array([0, 10, 20]))


def test_unretained_epoch_layout_typed():
    rt = ShardRoutingTable(100, 2)
    with pytest.raises(EpochError):
        rt.layout(99)


# ---------------------------------------------------------------------------
# the facade shims construct the same engine as an explicit plan
# ---------------------------------------------------------------------------


def _tiny():
    g = knn.road_network(6, 6, seed=0)
    objects = knn.pick_objects(g.n, 0.2, seed=0)
    return g, objects, knn.build_bngraph(g)


def test_legacy_shards_kwarg_equals_plan():
    g, objects, bn = _tiny()
    legacy = knn.build_sharded_engine(bn, objects, 4, shards=2, device="cpu")
    planned = knn.build_sharded_engine(bn, objects, 4, plan="shards=2", device="cpu")
    us = np.arange(g.n)
    assert np.array_equal(legacy.query_batch(us)[0].numpy(), planned.query_batch(us)[0].numpy())
    assert legacy.partition_plan() == planned.partition_plan()


def test_facade_rejects_plan_plus_legacy():
    g, objects, bn = _tiny()
    with pytest.raises(EngineConfigError):
        knn.build_sharded_engine(bn, objects, 4, plan="shards=1", shards=1, device="cpu")
    with pytest.raises(EngineConfigError):
        knn.load_engine("unused.npz", plan="shards=1", shards=1, device="cpu")


def test_engine_stats_report_partition_layout():
    g, objects, bn = _tiny()
    eng = knn.build_sharded_engine(bn, objects, 4, plan="shards=1", device="cpu")
    stats = eng.stats()
    assert stats["shard_starts"] == [0]
    assert stats["uneven_ranges"] is False
    assert stats["repartitions"] == 0
    assert eng.partition_plan().describe()["shards"] == 1
