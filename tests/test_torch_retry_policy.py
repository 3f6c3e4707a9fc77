"""RetryPolicy timing semantics — all on an injected fake clock (tier-1
must not sleep for real): backoff growth, jitter bounds, deadline-budget
exhaustion, and that producer/consumer/metadata clients all route their
retries through ONE RetryPolicy (the issue-2 retry unification).

Twin of `tests/test_retry_policy.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import random

import pytest

from ripplemq_tpu_torch.client.consumer import ConsumeError, ConsumerClient
from ripplemq_tpu_torch.client.metadata import MetadataError, MetadataManager
from ripplemq_tpu_torch.client.producer import ProduceError, ProducerClient
from ripplemq_tpu_torch.metadata.models import (
    BrokerInfo,
    PartitionAssignment,
    Topic,
    topics_to_wire,
)
from ripplemq_tpu_torch.wire import InProcNetwork
from ripplemq_tpu_torch.wire.retry import RetryPolicy, fatal_response_error
from tests.torch_port_modules import admit

admit(__name__)


class FakeClock:
    """monotonic + sleep pair where sleeping advances the clock."""

    def __init__(self) -> None:
        self.t = 0.0
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.t += s


def make_policy(clock: FakeClock, **kw) -> RetryPolicy:
    kw.setdefault("jitter", 0.0)
    return RetryPolicy(clock=clock.monotonic, sleep=clock.sleep, **kw)


# ------------------------------------------------------------ pure policy

def test_backoff_growth_exponential_with_cap():
    clock = FakeClock()
    p = make_policy(clock, max_attempts=7, base_backoff_s=0.1,
                    max_backoff_s=1.0, multiplier=2.0)
    run = p.begin()
    while run.attempt():
        run.note("nope")
    assert run.attempts == 7
    assert clock.sleeps == pytest.approx([0.1, 0.2, 0.4, 0.8, 1.0, 1.0])


def test_jitter_bounds():
    clock = FakeClock()
    p = RetryPolicy(max_attempts=20, base_backoff_s=0.1, max_backoff_s=1.0,
                    multiplier=2.0, jitter=0.5,
                    clock=clock.monotonic, sleep=clock.sleep,
                    rng=random.Random(42))
    run = p.begin()
    while run.attempt():
        pass
    assert len(clock.sleeps) == 19
    for k, s in enumerate(clock.sleeps, start=1):
        b = p.backoff_for(k)
        assert 0.5 * b <= s <= b, (k, s, b)
    # Jitter actually jitters (not all sleeps on the deterministic curve).
    assert len({round(s / p.backoff_for(k), 6)
                for k, s in enumerate(clock.sleeps, start=1)}) > 1


def test_deadline_budget_exhaustion_stops_attempts():
    clock = FakeClock()
    p = make_policy(clock, max_attempts=1000, base_backoff_s=0.2,
                    max_backoff_s=5.0, multiplier=2.0, deadline_s=1.0)
    run = p.begin()
    n = 0
    while run.attempt():
        n += 1
        clock.t += 0.05  # each attempt costs 50 ms of "RPC time"
    assert n < 1000          # the budget, not max_attempts, ended the loop
    assert clock.t <= 1.0 + 1e-9   # never slept past the deadline
    assert run.remaining_s() is not None


def test_clip_bounds_rpc_timeout_to_remaining_budget():
    clock = FakeClock()
    p = make_policy(clock, max_attempts=10, deadline_s=1.0)
    run = p.begin()
    assert run.attempt()
    assert run.clip(5.0) == pytest.approx(1.0)
    clock.t += 0.75
    assert run.clip(5.0) == pytest.approx(0.25)
    assert run.clip(0.1) == pytest.approx(0.1)


def test_fatal_taxonomy():
    assert fatal_response_error("bad_request: TypeError: x")
    assert fatal_response_error("unknown_partition: ('t', 9)")
    assert fatal_response_error("consumer_table_full: 8 slots")
    assert not fatal_response_error("not_leader")
    assert not fatal_response_error("not_committed: quorum lost")
    assert not fatal_response_error("unavailable: partition slot 1 ...")
    assert not fatal_response_error("stale_epoch")


def test_structural_refusals_are_fatal():
    """The retry_taxonomy lint rule's directed test: the structural deployment
    refusals shipped UNCLASSIFIED — clients burned their whole attempt/
    deadline budget against a broker that will never grow a store or a
    data dir within the operation's lifetime. Failing-before: every
    assertion in the first block was False."""
    assert fatal_response_error("no_store")
    assert fatal_response_error("no_data_dir")
    assert fatal_response_error("not_found")
    assert fatal_response_error("unknown engine op 'x'")
    assert fatal_response_error("unknown shard op 'y'")
    assert fatal_response_error("unknown request type 'z'")
    assert fatal_response_error("lockstep break: got seq 3, expected 2")
    # And the explicitly-retryable side stays retryable: transient by
    # construction, named in RETRYABLE_ERROR_PREFIXES (lint enforces
    # that every emitted prefix is in exactly one tuple).
    for err in ("bad_stripe_frame", "store_quarantined",
                "active_controller", "not_controller",
                "consumer_registration_failed", "internal: KeyError: x"):
        assert not fatal_response_error(err), err


def test_consume_fails_fast_on_no_store():
    """Directed failing-before test for the no_store classification: a
    consume answered with the structural refusal must surface after ONE
    attempt — before the fix the client retried max_attempts times with
    full backoff sleeps against a broker that can never serve."""
    net = InProcNetwork()
    handler, brokers = _meta_handler()
    calls = {"consume": 0}

    def broker0(req):
        if req.get("type") == "consume":
            calls["consume"] += 1
            return {"ok": False, "error": "no_store"}
        return handler(req)

    net.register(brokers[0].address, broker0)
    clock = FakeClock()
    policy = make_policy(clock, max_attempts=5, base_backoff_s=0.1,
                         max_backoff_s=1.0)
    consumer = ConsumerClient(
        [brokers[0].address], "c1",
        transport=net.client("consumer"),
        retry_policy=policy,
        metadata_refresh_s=3600,
    )
    try:
        with pytest.raises(ConsumeError) as ei:
            consumer.consume("t", partition=0)
        assert "no_store" in str(ei.value)
        assert calls["consume"] == 1, "retried a structural refusal"
        assert clock.sleeps == []
    finally:
        consumer.close()


# ------------------------------------------------- clients route through it

def _meta_handler(n_brokers=2):
    """A fake broker answering meta.topics with one 1-partition topic led
    by broker 0."""
    brokers = [BrokerInfo(i, "fake", 9000 + i) for i in range(n_brokers)]
    topic = Topic("t", 1, 1, (
        PartitionAssignment(0, (0,), leader=0, term=1),
    ))

    def handler(req):
        if req.get("type") == "meta.topics":
            return {"ok": True, "topics": topics_to_wire([topic]),
                    "brokers": [b.to_dict() for b in brokers]}
        return {"ok": False, "error": f"unexpected {req.get('type')}"}

    return handler, brokers


def test_partitioned_produce_stops_at_deadline_budget():
    """The acceptance scenario: the leader link partitions mid-produce;
    the produce must stop retrying when its deadline budget runs out —
    on the fake clock, with max_attempts set absurdly high — instead of
    looping on fixed sleeps."""
    net = InProcNetwork()
    handler, brokers = _meta_handler()
    net.register(brokers[0].address, handler)
    net.register(brokers[1].address, handler)
    clock = FakeClock()
    policy = RetryPolicy(max_attempts=10_000, base_backoff_s=0.05,
                         max_backoff_s=1.0, multiplier=2.0, jitter=0.0,
                         deadline_s=2.0,
                         clock=clock.monotonic, sleep=clock.sleep)
    producer = ProducerClient(
        [b.address for b in brokers],
        transport=net.client("producer"),
        retry_policy=policy,
        metadata_refresh_s=3600,
    )
    try:
        # Partition producer ↔ leader: produce RPCs now time out.
        net.block("producer", brokers[0].address)
        with pytest.raises(ProduceError) as ei:
            producer.produce("t", b"m", partition=0)
        assert "budget" in str(ei.value)
        assert clock.t <= 2.0 + 1e-9, "retried past the deadline budget"
        assert 1 < len(clock.sleeps) < 100, clock.sleeps
        # Backoffs grew (no fixed-sleep loop): later sleeps exceed earlier.
        assert clock.sleeps[3] > clock.sleeps[0]
    finally:
        producer.close()


def test_consumer_routes_retries_through_policy():
    net = InProcNetwork()
    handler, brokers = _meta_handler()
    net.register(brokers[0].address, handler)
    clock = FakeClock()
    policy = make_policy(clock, max_attempts=5, base_backoff_s=0.1,
                         max_backoff_s=1.0)
    consumer = ConsumerClient(
        [brokers[0].address], "c1",
        transport=net.client("consumer"),
        retry_policy=policy,
        metadata_refresh_s=3600,
    )
    try:
        net.block("consumer", brokers[0].address)
        with pytest.raises(ConsumeError) as ei:
            consumer.consume("t", partition=0)
        assert "5 attempt(s)" in str(ei.value)
        assert clock.sleeps == pytest.approx([0.1, 0.2, 0.4, 0.8])
    finally:
        consumer.close()


def test_metadata_routes_retries_through_policy():
    net = InProcNetwork()  # nothing registered: every fetch refuses
    clock = FakeClock()
    policy = make_policy(clock, max_attempts=4, base_backoff_s=0.25,
                         max_backoff_s=10.0)
    mgr = MetadataManager(
        net.client("meta"), ["nowhere:1"], retry_policy=policy
    )
    with pytest.raises(MetadataError) as ei:
        mgr.refresh()
    assert "4 attempt(s)" in str(ei.value)
    assert clock.sleeps == pytest.approx([0.25, 0.5, 1.0])


def test_commit_routes_retries_through_policy():
    net = InProcNetwork()
    handler, brokers = _meta_handler()
    net.register(brokers[0].address, handler)
    clock = FakeClock()
    policy = make_policy(clock, max_attempts=3, base_backoff_s=0.2,
                         max_backoff_s=1.0)
    consumer = ConsumerClient(
        [brokers[0].address], "c2",
        transport=net.client("consumer2"),
        retry_policy=policy,
        metadata_refresh_s=3600,
    )
    try:
        net.block("consumer2", brokers[0].address)
        with pytest.raises(ConsumeError):
            consumer.commit("t", 0, 7)
        assert clock.sleeps == pytest.approx([0.2, 0.4])
    finally:
        consumer.close()
