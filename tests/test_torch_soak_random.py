"""Randomized broker-runtime soak: a SEEDED fault schedule searches the
interleavings the hand-written soak scenario (test_soak.py) cannot —
the broker-level analogue of the engine's randomized model check
(tests/test_model_check.py).

Each seed drives N rounds of a randomly-ordered schedule over
{kill+restart the controller, kill+restart the metadata leader,
kill+restart a random other broker, ring-wrapping produce burst, quiet
settle} under live produce traffic, healing the cluster and asserting
ZERO committed-entry loss after every round. Brokers run with durable
stores (data_dir), so restarts exercise store replay, peer-shard
refill, standby catch-up re-admission, and controller takeover from a
recovered stream — in whatever order the seed dictates.

(Store GC churn is deliberately not in the palette: its races are
covered deterministically by tests/test_store_gc.py, and unbounded
retention keeps every seed's loss check exact.)

Twin of `tests/test_soak_random.py` on the PyTorch port (CPU brokers),
slow-marked as the reference is. The reference's spmd-binding seed
is not run here (see the parameter list).
"""

from __future__ import annotations

import random
import threading
import time

import pytest

# Tier-1 runs with -m 'not slow' (ROADMAP.md): randomized multi-round fault soak: minutes per seed.
pytestmark = pytest.mark.slow

from ripplemq_tpu_torch.metadata.models import Topic
from tests.torch_helpers import InProcCluster, make_config
from tests.test_torch_soak import _drain, _produce, wait_until
from tests.torch_helpers import port_cfg
from tests.torch_port_modules import admit

admit(__name__)


def _live_controller(c, dead):
    """The agreed controller across live brokers, or None while their
    views still diverge (a heal gate passing on one broker's view would
    let the next fault round select victims from a cluster not yet in
    the state the gate claims)."""
    views = {b.manager.current_controller()
             for i, b in c.brokers.items() if i not in dead}
    return views.pop() if len(views) == 1 else None


def _cluster_healthy(c):
    """Every broker agrees on a controller whose data plane is up, and
    every partition has an advertised leader (the harness's own
    bootstrap predicate, so heal-gate and bootstrap check the same
    invariant)."""
    ctrl = _live_controller(c, set())
    if ctrl is None or c.brokers[ctrl].dataplane is None:
        return False
    if not c.brokers[ctrl].is_controller:
        return False
    return all(c._all_leaders_known(b) for b in c.brokers.values())


@pytest.mark.parametrize("seed,linearizable,engine_mode", [
    (11, False, "local"), (23, False, "local"), (37, False, "local"),
    (41, False, "local"), (53, False, "local"),
    # One schedule with the read-index barrier ON: consumes prove the
    # controller epoch through the standby ack stream, so every fault
    # round also exercises barrier x failover interleavings (refusals
    # during churn are retried by the drain helpers).
    (61, True, "local"),
    # The reference's seed-71 schedule runs its brokers' planes on the
    # spmd binding over virtual devices of one process. The port's spmd
    # binding is one process a mesh cell, which an in-process cluster
    # cannot host; its kill/restart churn is the lockstep drill's
    # (tests/test_torch_lockstep_drill.py).
])
def test_randomized_fault_schedule(seed, linearizable, engine_mode,
                                   tmp_path):
    rng = random.Random(seed)
    config = make_config(
        n_brokers=4,
        topics=(Topic("t", 2, 3),),
        # Tiny ring: bursts wrap it, so every restart replays a wrapped
        # store and lagging drains hit the store-served path.
        engine=port_cfg(partitions=2, replicas=3, slots=64, max_batch=8),
        standby_count=2,
        linearizable_reads=linearizable,
    )
    acked: list[bytes] = []
    dead: set[int] = set()

    broker_kwargs = (
        {i: {"engine_mode": "spmd"} for i in range(4)}
        if engine_mode == "spmd" else None
    )
    with InProcCluster(config, data_dir=tmp_path,
                       broker_kwargs=broker_kwargs) as c:
        c.wait_for_leaders()
        assert wait_until(
            lambda: len(next(iter(c.brokers.values()))
                        .manager.current_standbys()) >= 1,
            timeout=60,
        ), "no standby ever formed"
        client = c.client()

        def start_traffic():
            """Fresh traffic generation: the loss check after each round
            PAUSES production (drains chase a moving log otherwise), so
            each round gets its own thread pair + stop event."""
            stop = threading.Event()
            base = len(acked)

            def traffic(tid: int) -> None:
                i = 0
                while not stop.is_set():
                    payload = b"rs%d-%d-%d-%04d" % (seed, tid, base, i)
                    try:
                        _produce(c, client, "t", tid % 2, payload,
                                 dead=dead, stop=stop, timeout=90.0)
                        acked.append(payload)
                    except AssertionError:
                        pass
                    i += 1

            ts = [threading.Thread(target=traffic, args=(t,), daemon=True)
                  for t in range(2)]
            for t in ts:
                t.start()
            return stop, ts

        def stop_traffic(stop, ts):
            stop.set()
            for t in ts:
                t.join(timeout=90)
                assert not t.is_alive(), "traffic thread still running"

        stop, threads = start_traffic()
        assert wait_until(lambda: len(acked) >= 20, timeout=60), len(acked)

        faults = ["kill_controller", "kill_meta_leader", "kill_other",
                  "burst", "settle"]
        for rnd in range(3):
            fault = rng.choice(faults)
            if fault == "kill_controller":
                victim = _live_controller(c, dead)
            elif fault == "kill_meta_leader":
                victim = next(
                    (i for i, b in c.brokers.items()
                     if i not in dead and b.runner.node.role == "leader"),
                    None,
                )
            elif fault == "kill_other":
                ctrl = _live_controller(c, dead)
                cands = [i for i in c.brokers if i not in dead and i != ctrl]
                victim = rng.choice(cands) if cands else None
            else:
                victim = None

            if fault == "burst":
                # 160 single-message produces split over 2 partitions =
                # ~80 ALIGN-padded rounds per ring: both 64-slot rings
                # provably wrap.
                target = len(acked) + 160
                assert wait_until(
                    lambda: len(acked) >= target, timeout=120
                ), f"seed {seed} round {rnd}: burst never completed"
            elif fault == "settle":
                time.sleep(rng.uniform(0.5, 1.5))
            elif victim is not None:
                dead.add(victim)
                c.kill(victim)
                time.sleep(rng.uniform(0.5, 2.0))
                c.restart(victim)
                dead.discard(victim)

            # Heal: every broker up, a controller driving a plane, all
            # leaders advertised — then traffic must demonstrably flow.
            assert wait_until(lambda: _cluster_healthy(c), timeout=120), (
                f"seed {seed} round {rnd} ({fault}): cluster never healed"
            )
            resumed = len(acked) + 5
            assert wait_until(lambda: len(acked) >= resumed, timeout=90), (
                f"seed {seed} round {rnd} ({fault}): traffic never resumed"
            )
            # Zero committed-entry loss after EVERY round: pause
            # production (a drain under live traffic chases a moving
            # log), then a fresh consumer reads the full retained
            # history of both partitions (ring + store-served below
            # trim).
            stop_traffic(stop, threads)
            snapshot = list(acked)
            got: list[bytes] = []
            for pid in range(2):
                got.extend(_drain(c, client, "t", pid,
                                  f"chk-{seed}-{rnd}", dead=dead))
            missing = set(snapshot) - set(got)
            assert not missing, (
                f"seed {seed} round {rnd} ({fault}): {len(missing)} acked "
                f"messages lost of {len(snapshot)}: {sorted(missing)[:5]}"
            )
            if rnd < 2:
                stop, threads = start_traffic()
