"""SLO autopilot (ripplemq_tpu_torch/slo/): directed control-loop
tests on an injectable clock with a SCRIPTED metrics feed — ramp →
shed engages → heal → rails respected → convergence — plus the
failing-before proof that STATIC knobs miss the same SLO under the
same feed, token-bucket/admission semantics, the producer's
backoff-aware `overloaded:` handling, config validation, and the live
DataPlane knob surface. Zero real sleeps outside the one DataPlane
integration test.

Twin of `tests/test_slo.py` on the PyTorch port (CPU brokers).
"""

from __future__ import annotations

import dataclasses

import pytest

from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig
from ripplemq_tpu_torch.metadata.models import BrokerInfo
from ripplemq_tpu_torch.obs.metrics import Metrics
from ripplemq_tpu_torch.obs.trace import FlightRecorder
from ripplemq_tpu_torch.slo.admission import AdmissionController, TokenBucket
from ripplemq_tpu_torch.slo.controller import SloController
from tests.torch_port_modules import admit

admit(__name__)


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def time(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


class FakePlane:
    """The plant's knob surface: mirrors DataPlane.set_knobs/knob_state
    semantics (clamps, soft window in [1, cap]) without a device."""

    def __init__(self, cap: int = 8) -> None:
        self.read_coalesce_s = 0.004
        self.chain_depth = 8
        self.cap = cap
        self._soft = cap
        self.settle_inflight = 0
        self.settle_backpressure = 0
        self.step_errors = 0
        self.stalled: list[int] = []

    def knob_state(self) -> dict:
        return {
            "read_coalesce_s": self.read_coalesce_s,
            "chain_depth": self.chain_depth,
            "settle_window": self._soft,
            "settle_window_cap": self.cap,
            "settle_inflight": self.settle_inflight,
        }

    def set_knobs(self, read_coalesce_s=None, chain_depth=None,
                  settle_window=None) -> dict:
        if read_coalesce_s is not None:
            self.read_coalesce_s = max(0.0, float(read_coalesce_s))
        if chain_depth is not None:
            self.chain_depth = max(1, int(chain_depth))
        if settle_window is not None:
            self._soft = min(self.cap, max(1, int(settle_window)))
        return self.knob_state()

    def stalled_slots(self):
        return list(self.stalled)


def slo_config(**kw) -> ClusterConfig:
    kw.setdefault("slo_p99_ack_ms", 20.0)
    kw.setdefault("slo_tick_s", 0.2)
    kw.setdefault("slo_read_coalesce_min_s", 0.001)
    kw.setdefault("slo_read_coalesce_max_s", 0.008)
    kw.setdefault("slo_chain_depth_min", 1)
    kw.setdefault("slo_chain_depth_max", 16)
    kw.setdefault("slo_settle_window_min", 2)
    return ClusterConfig(brokers=(BrokerInfo(0, "h", 9000),), topics=(),
                         **kw)


def make_controller(config=None, plane=None, degraded=None):
    clock = FakeClock()
    metrics = Metrics(enabled=True, clock=clock.time)
    recorder = FlightRecorder(clock=clock.time)
    degraded_box = {"v": False} if degraded is None else degraded
    ctl = SloController(
        config or slo_config(), metrics, recorder,
        dataplane_fn=(lambda: plane),
        degraded_fn=(lambda: degraded_box["v"]),
        clock=clock.time, wall_clock=clock.time,
    )
    return ctl, metrics, recorder, clock, degraded_box


def plant_p99_ms(plane: FakePlane) -> float:
    """The scripted plant under heavy load: every operating knob buys
    throughput by adding ack latency — the tradeoff the real operating
    curve measures (bench.py operating_curve)."""
    return (2.0 + plane.read_coalesce_s * 1000.0
            + plane.chain_depth * 1.5 + plane._soft * 1.0)


def feed(metrics: Metrics, p99_ms: float, n: int = 8) -> None:
    metrics.histogram("produce.ack_us").observe_int(int(p99_ms * 1000))
    for _ in range(n - 1):
        metrics.histogram("produce.ack_us").observe_int(
            int(p99_ms * 1000) - 1)


def drive(ctl, metrics, clock, plane, ticks: int) -> list[dict]:
    out = []
    for _ in range(ticks):
        feed(metrics, plant_p99_ms(plane))
        clock.advance(ctl.tick_s)
        out.append(ctl.tick())
    return out


# ------------------------------------------------------------ control law


def test_static_knobs_miss_the_slo_under_the_feed():
    """FAILING-BEFORE: the same plant at its static operating point
    (the deployment's configured knobs, untouched) sits ABOVE the p99
    target on every window — exactly what every pre-autopilot
    deployment shipped. The log2 histogram quantizes up, so assert on
    the bucketized value the controller itself would read."""
    ctl, metrics, recorder, clock, _ = make_controller(plane=None)
    plane = FakePlane()
    # No controller: feed the static plant and read the window p99 the
    # way the loop does.
    results = []
    for _ in range(10):
        feed(metrics, plant_p99_ms(plane))
        clock.advance(0.2)
        results.append(ctl.tick())  # dataplane_fn -> None: measure only
    sampled = [r for r in results if r["ok"] is not None]
    assert sampled, "feed never produced a sampled window"
    assert all(r["ok"] is False for r in sampled), (
        f"static knobs were expected to miss the {ctl.target_ms} ms "
        f"target: {sampled}"
    )


def test_controller_converges_the_same_feed_to_slo():
    """The same plant + the control loop: AIMD walks the knobs down
    until the windowed p99 meets the target, and holds there."""
    plane = FakePlane()
    ctl, metrics, recorder, clock, _ = make_controller(plane=plane)
    results = drive(ctl, metrics, clock, plane, 12)
    oks = [r["ok"] for r in results if r["ok"] is not None]
    assert oks[-1] is True, (plane.knob_state(), results[-3:])
    # Convergence is monotone here (pure multiplicative decrease) and
    # the loop recorded its decisions as slo_adjust trace events.
    kinds = [e["type"] for e in recorder.snapshot()]
    assert "slo_adjust" in kinds
    assert ctl.stats()["adjustments"] >= 1
    # Still meeting SLO a few ticks later — no oscillation back out.
    more = drive(ctl, metrics, clock, plane, 4)
    assert all(r["ok"] for r in more if r["ok"] is not None)


def test_rails_are_respected_and_recovery_walks_back():
    """Breach forever: every knob stops exactly at its rail floor.
    Then a comfortable plant: knobs walk back up, capped at the rails
    (and the settle window at the plane's configured cap)."""
    plane = FakePlane()
    cfg = slo_config()
    ctl, metrics, recorder, clock, _ = make_controller(cfg, plane=plane)
    # Force breach regardless of knobs: a constant 400 ms plant.
    for _ in range(12):
        feed(metrics, 400.0)
        clock.advance(ctl.tick_s)
        ctl.tick()
    ks = plane.knob_state()
    assert ks["read_coalesce_s"] == pytest.approx(
        cfg.slo_read_coalesce_min_s)
    assert ks["chain_depth"] == cfg.slo_chain_depth_min
    assert ks["settle_window"] == cfg.slo_settle_window_min
    # Comfortable plant (well under half the target): additive walk-up,
    # capped at the rails/plane cap.
    for _ in range(64):
        feed(metrics, 1.0)
        clock.advance(ctl.tick_s)
        ctl.tick()
    ks = plane.knob_state()
    assert ks["read_coalesce_s"] == pytest.approx(
        cfg.slo_read_coalesce_max_s)
    assert ks["chain_depth"] == min(cfg.slo_chain_depth_max, 16)
    assert ks["settle_window"] == plane.cap


def test_chain_depth_moves_on_a_power_of_two_ladder():
    """Each distinct chain depth is its own compiled device program:
    the controller must only ever visit the halving/doubling ladder of
    the starting depth (log2(max) programs), never walk +1 steps."""
    plane = FakePlane()
    ctl, metrics, recorder, clock, _ = make_controller(plane=plane)
    seen = {plane.chain_depth}
    for p99 in [400.0] * 6 + [1.0] * 10 + [400.0] * 3:
        feed(metrics, p99)
        clock.advance(ctl.tick_s)
        ctl.tick()
        seen.add(plane.chain_depth)
    assert seen <= {1, 2, 4, 8, 16}, seen


# ------------------------------------------------------------ shed machine


def test_shed_engages_on_quorum_degradation_and_hysteresis_off():
    """Ramp → shed engages (immediately on the degraded signal) →
    heal → disengages only after the hysteresis window of clean ticks.
    Transitions emit the closed-vocabulary trace events and flip the
    admission gate."""
    plane = FakePlane()
    ctl, metrics, recorder, clock, degraded = make_controller(plane=plane)
    r = ctl.tick()
    assert not r["shed"] and not ctl.admission.shedding
    degraded["v"] = True
    clock.advance(ctl.tick_s)
    r = ctl.tick()
    assert r["shed"] and "quorum_degraded" in r["reasons"]
    assert ctl.admission.shedding
    assert ctl.stats()["mode"] == "shed"
    # Heal: stays shedding through the hysteresis window, then off.
    degraded["v"] = False
    states = []
    for _ in range(6):
        clock.advance(ctl.tick_s)
        states.append(ctl.tick()["shed"])
    assert states[0] is True and states[1] is True  # hysteresis
    assert states[-1] is False
    assert not ctl.admission.shedding
    kinds = [e["type"] for e in recorder.snapshot()]
    assert "slo_shed_on" in kinds and "slo_shed_off" in kinds
    assert ctl.stats()["shed_count"] == 1
    # The tick ring carries the timeline the chaos verdict replays.
    hist = ctl.stats()["tick_history"]
    assert any(row[3] == 1.0 for row in hist)
    assert hist[-1][3] == 0.0


def test_shed_engages_on_settle_failures_and_occupancy_evidence():
    """The event-integrated signals: settle failures (step_errors
    delta) or backpressure increments on >= 2 of the last 5 ticks
    engage — even NON-consecutive ticks (client backoff spaces a
    sustained outage's symptoms out; a consecutive-streak rule would
    read it as one-off blips)."""
    plane = FakePlane()
    ctl, metrics, recorder, clock, _ = make_controller(plane=plane)
    # Failures on ticks 1 and 3 (non-consecutive) of the window.
    for i in range(4):
        if i in (0, 2):
            plane.step_errors += 3
        clock.advance(ctl.tick_s)
        r = ctl.tick()
    assert r["shed"] and "settle_failures" in r["reasons"]

    plane2 = FakePlane()
    ctl2, m2, _, clock2, _ = make_controller(plane=plane2)
    plane2.settle_inflight = plane2.cap  # >= ceil(0.75 * window)
    clock2.advance(ctl2.tick_s)
    assert not ctl2.tick()["shed"]  # one evidencing tick is not enough
    clock2.advance(ctl2.tick_s)
    r = ctl2.tick()
    assert r["shed"] and "settle_occupancy" in r["reasons"]


def test_p99_breach_alone_never_sheds():
    """FAILING-BEFORE (caught live while driving the verify recipe): a
    p99 breach with an EMPTY settle window is structural slowness —
    boot-time compiles, the worker-hop floor on a starved 2-core host —
    not overload; shedding cannot drain a queue that does not exist,
    and the first cut shed-flapped a perfectly healthy host_workers=2
    cluster off exactly this. The breach must drive the AIMD law only;
    shedding needs queueing/degradation evidence (the shed
    machine's threshold list: occupancy, stall streaks, quorum degradation — plus settle
    failures)."""
    plane = FakePlane()
    ctl, metrics, recorder, clock, _ = make_controller(plane=plane)
    for _ in range(10):
        feed(metrics, 3000.0)  # 3 s acks, zero occupancy/failures
        clock.advance(ctl.tick_s)
        r = ctl.tick()
        assert not r["shed"], r
    # The breach still steered the knobs down (AIMD reacted) even
    # though admission stayed open.
    assert not ctl.admission.shedding
    assert ctl.stats()["adjustments"] >= 1
    assert plane.chain_depth == 1  # floored by the breach windows


# ------------------------------------------------------- admission control


def test_token_bucket_refill_and_burst():
    clock = FakeClock()
    b = TokenBucket(10.0, clock.time())
    assert b.take(10, clock.time())          # full burst available
    assert not b.take(1, clock.time())       # drained
    clock.advance(0.5)                       # +5 tokens
    assert b.take(5, clock.time())
    assert not b.take(1, clock.time())
    clock.advance(100.0)                     # refill clamps at burst
    assert b.take(10, clock.time())


def test_token_bucket_oversize_batch_admits_as_debt():
    """FAILING-BEFORE (review-caught livelock): a batch larger than one
    second's rate must be admitted as DEBT when the bucket is positive
    — `tokens >= n` can never hold for n > burst, so the 'retry with
    backoff' refusal would livelock a healthy in-quota tenant forever.
    The debt still bills the long-run rate: the tenant waits it out."""
    clock = FakeClock()
    b = TokenBucket(10.0, clock.time())
    assert b.take(45, clock.time())          # 4.5x the burst: admitted
    assert not b.take(1, clock.time())       # deep in debt: refused
    clock.advance(3.0)                       # -35 + 30 = still negative
    assert not b.take(1, clock.time())
    clock.advance(0.6)                       # debt paid off (+6 > 5)
    assert b.take(1, clock.time())
    # The same shape through the admission front door.
    adm = AdmissionController({"gold": 10.0}, clock=clock.time)
    clock.advance(10.0)
    assert adm.admit("gold/p", 45) is None   # oversize batch admitted
    assert adm.admit("gold/p", 1) is not None  # debt window bills it


def test_admission_quota_and_shed_tiers():
    clock = FakeClock()
    adm = AdmissionController({"gold": 100.0}, clock=clock.time)
    # Healthy: unquoted tenants are unmetered, quota'd tenants capped.
    assert adm.admit("anon/1", 5) is None
    assert adm.admit(None, 5) is None
    assert adm.admit("gold/p1", 100) is None
    refusal = adm.admit("gold/p1", 1)
    assert refusal is not None and "quota" in refusal
    # Shedding: best-effort refused, gold keeps its bucket.
    adm.set_shed(True)
    refusal = adm.admit("anon/1", 1)
    assert refusal is not None and "best-effort" in refusal
    assert adm.admit(None, 1) is not None
    clock.advance(1.0)  # gold's bucket refills
    assert adm.admit("gold/p1", 50) is None
    adm.set_shed(False)
    assert adm.admit("anon/1", 1) is None
    st = adm.stats()
    assert st["shed_refusals"] >= 2 and st["quota_refusals"] >= 1


def test_shed_ladder_tiers_keep_high_tenant_admitted():
    """Directed ladder walk (slo_tenant_tiers): the shed gate refuses
    tier by tier, and a "high"-tier tenant stays admitted at EVERY
    level — shedding protects paying traffic, it never rations it.
    Level 1 drops best-effort only; level 2 also drops "low"; "high"
    (explicit, or implied by holding a quota) rides through both."""
    clock = FakeClock()
    adm = AdmissionController(
        {"gold": 100.0},
        clock=clock.time,
        tiers={"gold": "high", "bronze": "low"},
    )
    assert adm.tier_of("gold") == "high"
    assert adm.tier_of("bronze") == "low"
    assert adm.tier_of("anon") == "best_effort"

    # Level 0: everyone in.
    for name in ("gold/p", "bronze/p", "anon/p", None):
        assert adm.admit(name, 1) is None

    # Level 1: best-effort out, both prioritized tiers still in.
    adm.set_shed_level(1)
    refusal = adm.admit("anon/p", 1)
    assert refusal is not None and "best-effort" in refusal
    assert adm.admit(None, 1) is not None  # anonymous = best-effort
    assert adm.admit("bronze/p", 1) is None
    assert adm.admit("gold/p", 1) is None

    # Level 2: "low" out too — with its OWN refusal reason, so a shed
    # bronze tenant can tell rationing from a broker that lost its
    # quota config. "high" still admitted (quota permitting).
    adm.set_shed_level(2)
    refusal = adm.admit("bronze/p", 1)
    assert refusal is not None and "'low'-tier" in refusal
    assert "best-effort" not in refusal
    assert adm.admit("gold/p", 1) is None

    # The quota still bills the protected tier: high-priority is not
    # unmetered, it is just never shed.
    clock.advance(1.0)
    assert adm.admit("gold/p", 200) is None          # debt-admitted
    quota_refusal = adm.admit("gold/p", 1)
    assert quota_refusal is not None and "quota" in quota_refusal

    # Ladder down: level 1 re-admits bronze, level 0 re-admits all.
    adm.set_shed_level(1)
    assert adm.admit("bronze/p", 1) is None
    adm.set_shed_level(0)
    assert adm.admit("anon/p", 1) is None
    st = adm.stats()
    assert st["tier_tenants"] == 2
    assert st["shed_level"] == 0 and not st["shedding"]
    assert st["shed_refusals"] >= 3 and st["quota_refusals"] >= 1


def test_overloaded_is_retryable_and_producer_backs_off():
    """The client half of the shed contract: `overloaded:` is in the
    retryable taxonomy, and the producer retries it through its
    jittered exponential backoff (growing sleeps), succeeding once the
    broker stops shedding — all on a fake clock."""
    from ripplemq_tpu_torch.client.producer import ProducerClient
    from ripplemq_tpu_torch.wire.retry import RetryPolicy, fatal_response_error
    from ripplemq_tpu_torch.wire.transport import InProcNetwork

    assert not fatal_response_error("overloaded: shedding best-effort")

    from ripplemq_tpu_torch.metadata.models import (
        PartitionAssignment,
        Topic,
        topics_to_wire,
    )

    broker = BrokerInfo(0, "fake", 9000)
    topic = Topic("t", 1, 1, (PartitionAssignment(0, (0,), leader=0,
                                                  term=1),))
    refusals = {"n": 2}
    produces = []

    def handler(req):
        if req.get("type") == "meta.topics":
            return {"ok": True, "topics": topics_to_wire([topic]),
                    "brokers": [broker.to_dict()]}
        if req.get("type") == "produce":
            produces.append(req)
            if refusals["n"] > 0:
                refusals["n"] -= 1
                return {"ok": False,
                        "error": "overloaded: shedding best-effort "
                                 "traffic; retry with backoff"}
            return {"ok": True, "base_offset": 0, "count": 1}
        return {"ok": False, "error": f"unexpected {req.get('type')}"}

    net = InProcNetwork()
    net.register(broker.address, handler)
    clock = FakeClock()
    sleeps: list[float] = []
    policy = RetryPolicy(max_attempts=6, base_backoff_s=0.1,
                         max_backoff_s=2.0, multiplier=2.0, jitter=0.0,
                         clock=clock.time, sleep=sleeps.append)
    producer = ProducerClient(
        [broker.address], transport=net.client("p"),
        retry_policy=policy, metadata_refresh_s=3600,
        idempotence=False, producer_name="besteffort/x",
    )
    try:
        assert producer.produce("t", b"m", partition=0) == 0
    finally:
        producer.close()
    assert len(produces) == 3  # 2 refusals + the admitted retry
    # Tenancy rode the wire, and the backoff GREW between retries.
    assert all(r.get("producer") == "besteffort/x" for r in produces)
    assert len(sleeps) == 2 and sleeps[1] > sleeps[0]


def test_produce_surface_refuses_before_any_work():
    """Admission lives at the TOP of the produce RPC: a shedding
    broker refuses with `overloaded:` without touching partition
    resolution or validation (the refusal must be cheaper than the
    work it sheds) — white-box via the server's dispatch on a
    constructed-but-unstarted broker."""
    from ripplemq_tpu_torch.broker.server import BrokerServer
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config
    from ripplemq_tpu_torch.wire.transport import InProcNetwork

    config = make_cluster_config(n_brokers=1, slo_quotas=(("gold", 5.0),))
    net = InProcNetwork()
    broker = BrokerServer(0, config, net=net, device="cpu")
    broker.start()
    try:
        broker.slo.admission.set_shed(True)
        resp = broker.dispatch({"type": "produce", "topic": "nosuch",
                                "partition": 99, "messages": [b"m"],
                                "producer": "anon/1"})
        # Refused at admission — NOT the bad_request/unknown_partition
        # the nonexistent topic would have drawn from deeper layers.
        assert not resp["ok"] and resp["error"].startswith("overloaded:")
        broker.slo.admission.set_shed(False)
        resp = broker.dispatch({"type": "produce", "topic": "nosuch",
                                "partition": 99, "messages": [b"m"],
                                "producer": "gold/1"})
        assert not resp["ok"] and not resp["error"].startswith(
            "overloaded:")
        # admin.stats carries the slo block on every broker.
        st = broker.dispatch({"type": "admin.stats"})
        assert st["slo"]["enabled"] is False
        assert st["slo"]["admission"]["quota_tenants"] == 1
    finally:
        broker.stop()


# ----------------------------------------------------- config + live plane


def test_config_validation():
    base = dict(brokers=(BrokerInfo(0, "h", 9000),), topics=())
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_p99_ack_ms=10.0, obs=False)
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_tick_s=0.0)
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_read_coalesce_min_s=0.01,
                      slo_read_coalesce_max_s=0.001)
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_chain_depth_min=4, slo_chain_depth_max=2)
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_shed_occupancy=0.0)
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_quotas=(("", 5.0),))
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_quotas=(("t", 0.0),))
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_p99_consume_ms=10.0, obs=False)
    with pytest.raises(ValueError):
        ClusterConfig(**base, slo_p99_consume_ms=-1.0)
    ok = ClusterConfig(**base, slo_p99_ack_ms=10.0,
                       slo_quotas=(("t", 5.0),))
    assert ok.slo_recover_s > 0


def test_dataplane_set_knobs_live():
    """The real plane's knob surface: set_knobs applies under the
    plane's lock, the settle window narrows by holding semaphore
    permits (and widens by releasing them), and traffic keeps flowing
    at the narrowed window."""
    from ripplemq_tpu_torch.broker.dataplane import DataPlane
    from tests.torch_helpers import port_cfg

    dp = DataPlane(port_cfg(), mode="local", device="cpu")
    dp.start()
    try:
        ks = dp.knob_state()
        assert ks["settle_window"] == ks["settle_window_cap"]
        applied = dp.set_knobs(read_coalesce_s=0.003, chain_depth=2,
                               settle_window=1)
        assert applied["read_coalesce_s"] == pytest.approx(0.003)
        assert applied["chain_depth"] == 2
        assert applied["settle_window"] == 1
        dp.set_leader(0, 0, 1)
        futs = [dp.submit_append(0, [f"m{i}".encode()]) for i in range(8)]
        assert [f.result(timeout=20) is not None for f in futs]
        # Widen back to the cap: held permits release.
        applied = dp.set_knobs(settle_window=99)
        assert applied["settle_window"] == applied["settle_window_cap"]
        assert dp.submit_append(0, [b"post"]).result(timeout=20) is not None
    finally:
        dp.stop()


# --------------------------------------------------------- consume twin


def feed_consume(metrics: Metrics, p99_ms: float, n: int = 8) -> None:
    """The consume-side feed twin: observe the consume-ack window the
    broker's _handle_consume instrumentation fills."""
    h = metrics.histogram("consume.ack_us")
    h.observe_int(int(p99_ms * 1000))
    for _ in range(n - 1):
        h.observe_int(int(p99_ms * 1000) - 1)


def _prime(ctl, clock):
    """First tick only establishes the cumulative-bin baseline (the
    window p99 is a delta between snapshots); adjustments start on the
    second."""
    clock.advance(ctl.tick_s)
    ctl.tick()


def test_consume_twin_halves_coalesce_on_breach():
    plane = FakePlane()
    cfg = slo_config(slo_p99_ack_ms=0.0, slo_p99_consume_ms=10.0)
    ctl, metrics, recorder, clock, _ = make_controller(cfg, plane)
    # The consume target alone runs the loop (produce law dormant).
    assert not ctl.enabled and ctl.consume_enabled
    _prime(ctl, clock)
    feed_consume(metrics, 40.0)
    clock.advance(ctl.tick_s)
    out = ctl.tick()
    assert out["consume_ok"] is False
    assert plane.read_coalesce_s == pytest.approx(0.002)
    feed_consume(metrics, 40.0)
    clock.advance(ctl.tick_s)
    ctl.tick()
    # Multiplicative decrease rides down to the rail, never below.
    assert plane.read_coalesce_s == pytest.approx(0.001)
    evs = [e for e in recorder.snapshot() if e["type"] == "slo_adjust"]
    assert evs and all(e["loop"] == "consume" for e in evs)


def test_consume_twin_walks_back_only_with_real_margin():
    plane = FakePlane()
    plane.read_coalesce_s = 0.001
    cfg = slo_config(slo_p99_ack_ms=0.0, slo_p99_consume_ms=10.0)
    ctl, metrics, recorder, clock, _ = make_controller(cfg, plane)
    _prime(ctl, clock)
    feed_consume(metrics, 2.0)  # comfortably under half the target
    clock.advance(ctl.tick_s)
    ctl.tick()
    assert plane.read_coalesce_s > 0.001
    # Merely meeting the target is equilibrium, not headroom: a p99 in
    # (target/2, target] holds the knob still.
    rc = plane.read_coalesce_s
    feed_consume(metrics, 6.0)  # log2 bins read this as ~8.2 ms
    clock.advance(ctl.tick_s)
    out = ctl.tick()
    assert out["consume_ok"] is True
    assert plane.read_coalesce_s == pytest.approx(rc)


def test_consume_increase_suppressed_during_produce_breach():
    """The knob is shared: the tick the produce law halves
    read_coalesce_s, a comfortable consume window must not re-raise it
    (oscillation), even though its own law says increase."""
    plane = FakePlane()
    cfg = slo_config(slo_p99_ack_ms=20.0, slo_p99_consume_ms=10.0)
    ctl, metrics, recorder, clock, _ = make_controller(cfg, plane)
    _prime(ctl, clock)
    feed(metrics, 80.0)          # produce deep in breach
    feed_consume(metrics, 2.0)   # consume comfortable
    clock.advance(ctl.tick_s)
    ctl.tick()
    assert plane.read_coalesce_s == pytest.approx(0.002)
    evs = [e for e in recorder.snapshot() if e["type"] == "slo_adjust"]
    assert evs and all(e["loop"] == "produce" for e in evs)


def test_consume_twin_stats_surface():
    plane = FakePlane()
    cfg = slo_config(slo_p99_ack_ms=0.0, slo_p99_consume_ms=10.0)
    ctl, metrics, recorder, clock, _ = make_controller(cfg, plane)
    st = ctl.stats()
    assert st["consume_enabled"] is True
    assert st["target_p99_consume_ms"] == pytest.approx(10.0)
    assert st["mode"] != "off"
    _prime(ctl, clock)
    feed_consume(metrics, 4.0)
    clock.advance(ctl.tick_s)
    ctl.tick()
    st = ctl.stats()
    assert st["consume_p99_ms"] is not None
    assert st["consume_p99_ms"] <= 10.0
    assert st["consume_meeting_slo"] is True


# ------------------------------------------------------------ rails prior


def test_rails_prior_file_clamps_first_tick(tmp_path):
    """A measured prior (bench.py operating_curve format) narrows the
    config rails at construction, and the very first evidencing breach
    tick clamps against the PRIOR's floor, not the config's: halving
    the plane's 0.004 s coalesce would land at 0.002 — inside the
    config rails — but the prior floor of 0.003 catches it."""
    import json

    rails = tmp_path / "rails.json"
    rails.write_text(json.dumps({
        "method": "bench.py operating_curve",
        "rails": {"read_coalesce_min_s": 0.003,
                  "read_coalesce_max_s": 0.006,
                  "chain_depth_min": 2,
                  "chain_depth_max": 8,
                  "settle_window_min": 3},
    }))
    cfg = slo_config(slo_rails_file=str(rails))
    plane = FakePlane()
    ctl, metrics, recorder, clock, _ = make_controller(cfg, plane=plane)
    assert ctl.rc_min == pytest.approx(0.003)
    assert ctl.rc_max == pytest.approx(0.006)
    assert (ctl.cd_min, ctl.cd_max, ctl.sw_min) == (2, 8, 3)
    # Tick 1 only snapshots the histogram; tick 2 is the first MEASURED
    # window — deep in breach, so the MD law fires immediately.
    feed(metrics, 400.0)
    clock.advance(ctl.tick_s)
    ctl.tick()
    feed(metrics, 400.0)
    clock.advance(ctl.tick_s)
    ctl.tick()
    assert plane.read_coalesce_s == pytest.approx(0.003)  # not 0.002
    # Breach forever: every knob floors at the PRIOR's rails, which sit
    # strictly inside the config rails (0.001 / 1 / 2).
    for _ in range(10):
        feed(metrics, 400.0)
        clock.advance(ctl.tick_s)
        ctl.tick()
    ks = plane.knob_state()
    assert ks["read_coalesce_s"] == pytest.approx(0.003)
    assert ks["chain_depth"] == 2
    assert ks["settle_window"] == 3


def test_rails_prior_bad_file_keeps_config_rails(tmp_path):
    """A malformed or missing prior must never stop a broker from
    booting: the config rails stand."""
    bad = tmp_path / "rails.json"
    bad.write_text("{not json")
    cfg = slo_config(slo_rails_file=str(bad))
    ctl, _, _, _, _ = make_controller(cfg)
    assert ctl.rc_min == pytest.approx(cfg.slo_read_coalesce_min_s)
    assert ctl.rc_max == pytest.approx(cfg.slo_read_coalesce_max_s)
    assert ctl.cd_min == cfg.slo_chain_depth_min
    missing = slo_config(slo_rails_file=str(tmp_path / "nope.json"))
    ctl2, _, _, _, _ = make_controller(missing)
    assert ctl2.sw_min == missing.slo_settle_window_min


def test_rails_prior_inverted_pair_reordered(tmp_path):
    """A prior measured under a different build can carry an inverted
    pair; the loader re-orders instead of handing the AIMD law an
    empty range."""
    import json

    rails = tmp_path / "rails.json"
    rails.write_text(json.dumps({"rails": {
        "read_coalesce_min_s": 0.006, "read_coalesce_max_s": 0.002,
        "chain_depth_min": 12, "chain_depth_max": 4}}))
    ctl, _, _, _, _ = make_controller(
        slo_config(slo_rails_file=str(rails)))
    assert ctl.rc_min == pytest.approx(0.002)
    assert ctl.rc_max == pytest.approx(0.006)
    assert (ctl.cd_min, ctl.cd_max) == (4, 12)
