"""Soak: ring retention x controller failover x chained rounds, live.

Retention, failover and chained rounds interact here in one scenario
the per-feature suites cannot cover: partitions whose device ring has
WRAPPED (trim active, history store-served) lose their controller
mid-traffic, and the promoted standby must rebuild the wrapped ring
from its replicated committed-round stream — then keep serving full
history with zero committed-entry loss.

Twin of `tests/test_soak.py` on the PyTorch port (CPU brokers); its
`_produce` and `_drain` serve the port's other soak twins as the
reference's serve theirs.
"""

from __future__ import annotations

import threading
import time

import pytest

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.torch_helpers import port_cfg, wait_until
from tests.torch_port_modules import admit

admit(__name__)


@pytest.fixture()
def cluster4():
    config = make_config(
        n_brokers=4,
        topics=(Topic("t", 2, 3),),
        # TINY ring: every partition wraps many times during the test,
        # so the failover handover replays a wrapped store and lagging
        # reads exercise the store-served path.
        engine=port_cfg(partitions=2, replicas=3, slots=64, max_batch=8),
        standby_count=2,
    )
    with InProcCluster(config) as c:
        c.wait_for_leaders()
        yield c


def _produce(c, client, topic, pid, payload, dead=(), timeout=60.0,
             stop=None):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        if stop is not None and stop.is_set():
            raise AssertionError("stopped")  # traffic wind-down: not acked
        for b in c.brokers.values():
            if b.broker_id in dead:
                continue
            leader = b.manager.leader_of((topic, pid))
            if leader is None or leader in dead:
                continue
            try:
                resp = client.call(
                    c.brokers[leader].addr,
                    {"type": "produce", "topic": topic, "partition": pid,
                     "messages": [payload]},
                    timeout=5.0,
                )
            except Exception as e:
                last = e
                continue
            if resp.get("ok"):
                return
            last = resp
        time.sleep(0.05)
    raise AssertionError(f"produce never succeeded: {last}")


def _drain(c, client, topic, pid, consumer, dead=(), deadline_s=120.0):
    got: list[bytes] = []
    quiet = 0
    deadline = time.time() + deadline_s
    while quiet < 40:
        assert time.time() < deadline, (
            f"drain of {topic}[{pid}] stuck after {deadline_s}s "
            f"({len(got)} messages so far)"
        )
        live = [b for i, b in c.brokers.items() if i not in dead]
        leader = live[0].manager.leader_of((topic, pid))
        if leader is None or leader in dead:
            time.sleep(0.05)
            continue
        try:
            resp = client.call(
                c.brokers[leader].addr,
                {"type": "consume", "topic": topic, "partition": pid,
                 "consumer": consumer, "max_messages": 64},
                timeout=5.0,
            )
        except Exception:
            time.sleep(0.05)
            continue
        if not resp.get("ok"):
            time.sleep(0.05)
            continue
        msgs = resp["messages"]
        got.extend(msgs)
        if msgs:
            quiet = 0
            # Drive the commit to an ACKED success before the next
            # consume. A transiently refused commit (leadership or the
            # settle horizon still catching up post-recovery) means the
            # next consume legally re-serves the batch — at-least-once —
            # but these drains assert EXACT delivery, so swallowing the
            # refusal reads as a duplicate (observed: cold-restart drain
            # re-served its first batch under tier-1 host contention).
            while True:
                assert time.time() < deadline, (
                    f"offset.commit of {topic}[{pid}] never acked after "
                    f"{deadline_s}s ({len(got)} messages drained)"
                )
                live = [b for i, b in c.brokers.items() if i not in dead]
                leader = live[0].manager.leader_of((topic, pid))
                if leader is None or leader in dead:
                    time.sleep(0.05)
                    continue
                try:
                    ack = client.call(
                        c.brokers[leader].addr,
                        {"type": "offset.commit", "topic": topic,
                         "partition": pid, "consumer": consumer,
                         "offset": resp["next_offset"]},
                        timeout=5.0,
                    )
                except Exception:
                    time.sleep(0.05)
                    continue
                if ack.get("ok"):
                    break
                time.sleep(0.05)
        else:
            quiet += 1
            time.sleep(0.02)
    return got


def test_soak_ring_wrap_failover_zero_loss(cluster4):
    c = cluster4
    ctrl = c.config.controller
    client = c.client()
    assert wait_until(
        lambda: len(next(iter(c.brokers.values()))
                    .manager.current_standbys()) >= 2,
        timeout=60,
    ), "standby set never formed"

    acked: list[bytes] = []
    stop = threading.Event()
    dead: set[int] = set()

    def traffic(tid: int) -> None:
        i = 0
        while not stop.is_set():
            payload = b"soak-%d-%04d" % (tid, i)
            try:
                # `stop` passed through: a produce mid-retry at wind-down
                # must abort UNacked — a success landing after the
                # verification drain would read as spurious loss.
                _produce(c, client, "t", tid % 2, payload, dead=dead,
                         stop=stop)
                acked.append(payload)
            except AssertionError:
                pass
            i += 1

    threads = [threading.Thread(target=traffic, args=(t,), daemon=True)
               for t in range(4)]
    for t in threads:
        t.start()

    # Phase 1: wrap the ring several times over before the fault.
    assert wait_until(lambda: len(acked) >= 300, timeout=120), len(acked)
    survivor = next(b for i, b in c.brokers.items() if i != ctrl)

    # Phase 2: kill the controller mid-traffic.
    c.net.set_down(c.brokers[ctrl].addr)
    dead.add(ctrl)
    c.brokers[ctrl].stop()
    assert wait_until(
        lambda: survivor.manager.current_controller() != ctrl,
        timeout=60,
    ), "controller never moved"
    new_ctrl = survivor.manager.current_controller()
    assert wait_until(lambda: c.brokers[new_ctrl].dataplane is not None,
                      timeout=60)
    # The promoted standby replayed a WRAPPED store: its data plane's
    # trim watermark is active for the busy partitions.
    assert wait_until(
        lambda: int(c.brokers[new_ctrl].dataplane.trim.max()) > 0,
        timeout=60,
    ), "promoted ring never wrapped"

    # Phase 3: traffic continues through the handover, wrapping more.
    n_after = len(acked) + 100
    assert wait_until(lambda: len(acked) >= n_after, timeout=120), (
        "traffic never resumed after failover"
    )
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "traffic thread still running at drain"

    # Zero committed-entry loss across wrap + failover, including the
    # store-served history below the promoted controller's trim.
    got: list[bytes] = []
    for pid in range(2):
        got.extend(_drain(c, client, "t", pid, "soak-check", dead=dead))
    missing = set(acked) - set(got)
    assert not missing, (
        f"{len(missing)} acked messages lost of {len(acked)}: "
        f"{sorted(missing)[:5]}"
    )
