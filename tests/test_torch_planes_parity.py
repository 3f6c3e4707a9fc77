"""Slice E of the port against the JAX package, exactly, in one process.

Five differentials, each one seeded script through both packages:

1. the shared-memory ring: one record sequence (pushes, scatter-gather
   pushes, pops across wraps, a torn write left unpublished and a
   published frame damaged afterwards) through both `ShmRing`s — the
   shared-memory images byte for byte after every step, and what each
   reader returned;
2. the stripe sender: one stream of rounds through both
   `StripeReplicator`s on an `InProcNetwork` with four fake standbys
   each — every `repl.stripes` frame, member by member in gsn order, and
   every settle decision (k distinct stripe-acks settle with a member
   down; fewer than k live holders refuse);
3. the follower read plane: one ingest sequence of floors, gaps, epochs
   and stripe frames into both `FollowerReadPlane`s, then one read
   script — every answer and refusal, and the planes' stats;
4. the nemesis and the checker: `make_schedule` for seeds 0-7 on both
   backends and both replication modes gives equal `trace_json`, and one
   recorded history gives equal `check_history` / `check_group_history`
   verdicts;
5. the host plane: one deterministic workload through a port cluster
   with `host_workers=2` and the reference's with `host_workers=1` —
   byte-identical committed prefixes and offsets.

The reference computes the GF(2⁸) products with its CPU fallback
(`platform="cpu"`), the port with its plain version (`device="cpu"`).
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import pytest

from tests.torch_port_modules import admit

admit(__name__)

DEVICE_KW = {"ripplemq_tpu": {"platform": "cpu"},
             "ripplemq_tpu_torch": {"device": "cpu"}}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------- 1. ring


def _ring_script(pkg: str, seed: int):
    shmring = _mod(pkg, "parallel.shmring")
    cap = 1 << 12
    prod = shmring.ShmRing.create(cap)
    cons = shmring.ShmRing.attach(prod.name)
    rng = np.random.default_rng(seed)
    images, out = [], []

    def image():
        images.append(bytes(prod._shm.buf[: 64 + cap]))

    try:
        pending = 0
        for i in range(300):
            n = int(rng.integers(1, 600))
            body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            if rng.random() < 0.3:
                cut = int(rng.integers(0, n + 1))
                ok = prod.push_parts([body[:cut], body[cut:]], timeout_s=0)
            else:
                ok = prod.push(body, timeout_s=0)
            out.append(("push", i, bool(ok)))
            pending += bool(ok)
            if not ok or rng.random() < 0.4:
                while pending:
                    got = cons.pop(timeout_s=1.0)
                    out.append(("pop", bytes(got)))
                    pending -= 1
            out.append(("fill", prod.fill_fraction()))
            image()
        while pending:
            out.append(("pop", bytes(cons.pop(timeout_s=1.0))))
            pending -= 1
        image()
        # A torn write: frame bytes at the tail, the tail never advanced.
        tail = prod._tail()
        at = 64 + tail % cap
        torn = b"half-written frame"
        if at + 8 + len(torn) <= 64 + cap:
            prod._shm.buf[at + 8 : at + 8 + len(torn)] = torn
            prod._shm.buf[at : at + 8] = (len(torn).to_bytes(4, "little")
                                          + (12345).to_bytes(4, "little"))
        out.append(("torn", cons.pop(timeout_s=0.05)))
        image()
        # A published frame damaged afterwards: TornFrameError.
        prod.push(b"to-be-corrupted", timeout_s=1.0)
        tail = prod._tail()
        prod._shm.buf[64 + (tail - 8) % cap] ^= 0xFF
        try:
            cons.pop(timeout_s=1.0)
            out.append(("corrupt", "served"))
        except shmring.TornFrameError:
            out.append(("corrupt", "TornFrameError"))
        image()
    finally:
        cons.close()
        prod.close()
    return images, out


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_images_and_reads_equal_reference(seed):
    ref_images, ref_out = _ring_script("ripplemq_tpu", seed)
    port_images, port_out = _ring_script("ripplemq_tpu_torch", seed)
    assert len(port_images) == len(ref_images)
    for i, (a, b) in enumerate(zip(ref_images, port_images)):
        assert a == b, f"shared-memory image differs after step {i}"
    assert port_out == ref_out
    assert ("torn", None) in port_out
    assert port_out[-1] == ("corrupt", "TornFrameError")
    assert sum(1 for o in port_out if o[0] == "pop") > 100


# -------------------------------------------------------- 2. stripe sender

MEMBERS = (1, 2, 3, 4)
GSN0 = 1 << 30


def _wait_for(pred, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _sender_script(pkg: str, seed: int):
    plane = _mod(pkg, "stripes.plane")
    transport = _mod(pkg, "wire.transport")
    net = transport.InProcNetwork()
    got = {b: [] for b in MEMBERS}

    def holder(b):
        def handle(req):
            assert req["type"] == "repl.stripes" and req["epoch"] == 7
            got[b].extend(bytes(f) for f in req["frames"])
            return {"ok": True}
        return handle

    for b in MEMBERS:
        net.register(f"b{b}", holder(b))
    live = {"set": set(MEMBERS)}
    rep = plane.StripeReplicator(
        net.client("b0"), lambda b: f"b{b}",
        epoch_fn=lambda: 7, members_fn=lambda: MEMBERS,
        active_fn=lambda: True, live_fn=lambda: sorted(live["set"]),
        rpc_timeout_s=1.0, ack_timeout_s=30.0, sender_id=0,
        encode_kw=DEVICE_KW[pkg])
    rep._gsn = GSN0  # the wall-clock seed of the gsn counter, fixed
    rng = np.random.default_rng(seed)

    def rnd_round(slot):
        n = int(rng.integers(1, 5))
        return [(1, slot, int(rng.integers(0, 1 << 16)),
                 rng.integers(0, 256, int(rng.integers(1, 3000)),
                              dtype=np.uint8).tobytes())
                for _ in range(n)]

    decisions = []

    def settle(tickets):
        for t in tickets:
            try:
                rep.wait(t, timeout_s=20.0)
                decisions.append("settled")
            except Exception as e:
                decisions.append(type(e).__name__)

    def delivered(n_groups):
        return all(len(got[b]) == n_groups * (2 if b == 1 else 1)
                   for b in MEMBERS)

    try:
        groups = 0
        for i in range(4):  # one round a group
            settle([rep.begin(rnd_round(i))])
            groups += 1
        with rep._enc_cond:  # three rounds queued before the encoder
            tickets = [rep.begin(rnd_round(10 + i)) for i in range(3)]
        settle(tickets)  # one group commit of three rounds
        groups += 1
        _wait_for(lambda: delivered(groups), "every stripe delivered")
        # Holder 4 (stripe 3) down: stripes 0, 1, 2, 4 from three
        # distinct members still settle the round.
        net.set_down("b4")
        settle([rep.begin(rnd_round(20))])
        groups += 1
        net.set_up("b4")
        _wait_for(lambda: delivered(groups), "the down holder's backlog")
        # Fewer than k live holders (stripes 0 and 4 only): refused.
        live["set"] = {1}
        try:
            rep.begin(rnd_round(30))
            decisions.append("queued")
        except Exception as e:
            decisions.append(type(e).__name__)
    finally:
        rep.stop()
    return got, decisions


def test_stripe_sender_frames_and_settles_equal_reference():
    ref_got, ref_dec = _sender_script("ripplemq_tpu", 3)
    port_got, port_dec = _sender_script("ripplemq_tpu_torch", 3)
    assert port_dec == ref_dec
    assert port_dec == ["settled"] * 8 + ["ReplicationError"]
    for b in MEMBERS:
        assert port_got[b] == ref_got[b], f"member {b}'s frames differ"
    codec = _mod("ripplemq_tpu_torch", "stripes.codec")
    gsns = [codec.parse_frame(f).gsn for f in port_got[3]]
    assert gsns == sorted(gsns) and gsns[0] == GSN0


# -------------------------------------------------------- 3. follower plane

SB = 32


def _rows(payloads):
    out = bytearray()
    for p in payloads:
        row = bytearray(SB)
        row[0:4] = len(p).to_bytes(4, "little")
        row[8 : 8 + len(p)] = p
        out += row
    return bytes(out)


def _full_ingest(rng):
    """A seeded full-copy ingest sequence: pages, floors, gap maps and
    one generation change."""
    steps, ends = [], {0: 0, 1: 0, 2: 0}
    for i in range(40):
        if i == 25:
            steps.append(("epoch", 5))
            ends = {0: 0, 1: 0, 2: 0}
            continue
        epoch = 4 if i < 25 else 5
        slot = int(rng.integers(0, 3))
        base = ends[slot]
        if rng.random() < 0.2:
            base += int(rng.integers(1, 4))  # a leader gap
        n = int(rng.integers(1, 6))
        msgs = [f"e{epoch}-s{slot}-{base + j}".encode() * int(
            rng.integers(1, 3)) for j in range(n)]
        msgs = [m[: SB - 8] for m in msgs]
        gaps = [[ends[slot], base]] if base > ends[slot] else []
        ends[slot] = base + n
        floor = base + int(rng.integers(0, n + 1))
        stale = i == 30  # a frame from the old generation: dropped
        steps.append(("rounds", 4 if stale else epoch,
                      [(1, slot, base, _rows(msgs))],
                      [[slot, floor, gaps]]))
    return steps


def _striped_groups(pkg, rng):
    """Seeded stripe groups of one generation (one a tombstone), encoded
    by the package's own codec."""
    codec = _mod(pkg, "stripes.codec")
    groups, ends = [], {0: 0, 1: 0}
    for g in range(8):
        if g == 4:
            groups.append(codec.encode_group([], 9, 100 + g, tombstone=True,
                                             settled_floor=100 + g - 1,
                                             **DEVICE_KW[pkg]))
            continue
        recs = []
        for slot in (0, 1):
            n = int(rng.integers(1, 5))
            recs.append((1, slot, ends[slot], _rows(
                [f"g{g}-s{slot}-{j}".encode() for j in range(n)])))
            ends[slot] += n
        recs.append((2, 0, g, b"\x01\x00\x00\x00\x02\x00\x00\x00"))
        groups.append(codec.encode_group(recs, 9, 100 + g,
                                         settled_floor=100 + g - 1,
                                         **DEVICE_KW[pkg]))
    return groups


def _follower_script(pkg: str, seed: int):
    follower = _mod(pkg, "broker.follower")
    codec = _mod(pkg, "stripes.codec")
    rng = np.random.default_rng(seed)
    out = []
    # Full-copy plane: ingest, then a read script over every slot.
    fp = follower.FollowerReadPlane(SB, 12 * SB)
    for step in _full_ingest(rng):
        if step[0] == "epoch":
            fp.note_epoch(step[1])
        else:
            fp.ingest_rounds(*step[1:])
        for slot in range(3):
            for off in range(0, 12, 3):
                out.append(("full", slot, off, fp.read(slot, off, None)))
        out.append(("audit", fp.audit_answer(0, 0, 2),
                    fp.validate_window(1, 0, 1)))
    out.append(("floors", fp.floors()))
    out.append(("stats", fp.stats()))
    # Striped plane: this holder keeps stripe 3 (parity) of each group;
    # its siblings come from the fetch function, stripes 0 and 4, so
    # every decode is a GF(2^8) reconstruct.
    groups = _striped_groups(pkg, rng)
    parsed = [[codec.parse_frame(f) for f in g] for g in groups]
    fetched = []

    def fetch(min_gsn):
        fetched.append(min_gsn)
        return [f[i] for f in parsed for i in (0, 4) if f[i].gsn >= min_gsn]

    sp = follower.FollowerReadPlane(SB, 1 << 20, fetch_fn=fetch,
                                    decode_kw=DEVICE_KW[pkg])
    for k, frames in enumerate(parsed):
        sp.ingest_stripe(9, frames[3])
        for slot in (0, 1):
            for off in range(0, 4 * (k + 1), 2):
                out.append(("striped", k, slot, off, sp.read(slot, off, 3)))
    out.append(("floors", sp.floors()))
    out.append(("stats", sp.stats()))
    out.append(("fetched", fetched))
    return out


def test_follower_plane_answers_equal_reference():
    ref = _follower_script("ripplemq_tpu", 11)
    port = _follower_script("ripplemq_tpu_torch", 11)
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert b == a
    # 8 groups: one tombstone, and the last above every frame's floor
    stats = port[-2][1]
    assert stats["striped"]["decoded_groups"] == 6
    assert any(o[0] == "full" and o[3] is None for o in port)
    assert any(o[0] == "full" and o[3] and o[3][0] == [] for o in port)


# --------------------------------------------------- 4. nemesis and checker


@pytest.mark.parametrize("backend", ["inproc", "proc"])
@pytest.mark.parametrize("striped", [False, True])
def test_schedules_equal_reference(backend, striped):
    ref = _mod("ripplemq_tpu", "chaos.nemesis")
    port = _mod("ripplemq_tpu_torch", "chaos.nemesis")
    roster = [0, 1, 2, 3] if striped else [0, 1, 2]
    for seed in range(8):
        kw = dict(phases=3, ops_per_phase=3, backend=backend,
                  striped=striped)
        want = ref.make_schedule(seed, roster, **kw)
        got = port.make_schedule(seed, roster, **kw)
        assert port.trace_json(got) == ref.trace_json(want)
        assert (port.trace_json(port.expected_trace(got))
                == ref.trace_json(ref.expected_trace(want)))


def _recorded_history(seed: int):
    """A seeded history through the port's recorder — acked, failed and
    unknown produces, consumes (some out of order, some below an acked
    commit), commits, group views — and final logs with losses,
    duplicates and phantoms."""
    history = _mod("ripplemq_tpu_torch", "chaos.history").History()
    rng = np.random.default_rng(seed)
    logs = {("t", 0): [], ("t", 1): []}
    for i in range(120):
        p = int(rng.integers(0, 2))
        status = rng.choice(["ok", "ok", "ok", "fail", "unknown"])
        payload = f"m{i}"
        history.record(op="produce", client="p", topic="t", partition=p,
                       payload=payload, status=str(status),
                       attempts=int(rng.integers(1, 3)))
        if status != "fail" or rng.random() < 0.3:
            if rng.random() > 0.03:
                logs[("t", p)].append(payload)
            if rng.random() < 0.03:
                logs[("t", p)].append(payload)
    logs[("t", 1)].append("ghost")
    for c in ("c0", "c1"):
        for p in (0, 1):
            off = 0
            log = logs[("t", p)]
            while off < len(log):
                n = int(rng.integers(1, 6))
                got = log[off : off + n]
                if rng.random() < 0.05:
                    got = got[::-1]
                start = off if rng.random() > 0.05 else max(0, off - 3)
                history.record(op="consume", client=c, topic="t",
                               partition=p, status="ok", offset=start,
                               next_offset=off + len(got), payloads=got)
                off += len(got)
                history.record(op="commit", client=c, topic="t",
                               partition=p, status="ok", offset=off,
                               group="g" if c == "c1" else None,
                               member=c, generation=1,
                               stale=bool(rng.random() < 0.02))
    for gen, member, parts in [(1, "c0", [["t", 0]]), (1, "c1", [["t", 1]]),
                               (2, "c0", [["t", 0], ["t", 1]]),
                               (2, "c1", [["t", 1]])]:
        history.record(op="assignment", group="g", member=member,
                       generation=gen, partitions=parts)
    return history.ops(), logs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checker_verdicts_equal_reference(seed):
    ref = _mod("ripplemq_tpu", "chaos.history")
    port = _mod("ripplemq_tpu_torch", "chaos.history")
    ops, logs = _recorded_history(seed)
    t = ops[len(ops) // 2]["t"]
    for kw in ({}, {"stripe": {"k": 3, "m": 2, "holders_down": 2}},
               {"stripe": {"k": 3, "m": 2, "holders_down": 3}},
               {"loss_grace": [(t - 1.0, t + 1.0)]}):
        want = ref.check_history(ops, logs, **kw)
        assert port.check_history(ops, logs, **kw) == want
    assert ref.check_history(ops, logs), "the history holds no violation"
    want = ref.check_group_history(ops)
    assert port.check_group_history(ops) == want and want


# ------------------------------------------------------------ 5. host plane


def _drive_cluster(pkg: str, host_workers: int) -> dict:
    """A deterministic workload through one package's in-proc cluster:
    produces to each partition's leader, then every partition drained
    from 0: its committed prefix (every message, in order) and the
    offset the drain ended at. The answers' windows may differ (a host
    worker serves a contiguous run of its settled mirror in one answer,
    the single-process plane a round at a time); the bytes may not."""
    cluster_mod = _mod(pkg, "chaos.cluster")
    cfg = dataclasses.replace(cluster_mod.make_cluster_config(3),
                              host_workers=host_workers)
    kw = {"device": "cpu"} if pkg == "ripplemq_tpu_torch" else {}
    out = {}
    with cluster_mod.InProcCluster(cfg, **kw) as c:
        c.wait_for_leaders()
        client = c.client()

        def leader(p):
            return c.brokers[next(iter(c.brokers.values()))
                             .manager.leader_of(("topic1", p))]

        for i in range(8):
            for p in (0, 1):
                resp = client.call(leader(p).addr, {
                    "type": "produce", "topic": "topic1", "partition": p,
                    "messages": [b"p%d-i%d-m%d-" % (p, i, j) + bytes(
                        range(j * 5 % 12)) for j in range(i % 4 + 1)],
                }, timeout=30.0)
                assert resp.get("ok"), resp
        for p in (0, 1):
            msgs, offset = [], 0
            while True:
                resp = client.call(leader(p).addr, {
                    "type": "consume", "topic": "topic1", "partition": p,
                    "consumer": f"drain-{p}", "offset": offset,
                }, timeout=30.0)
                assert resp.get("ok"), resp
                if not resp["messages"]:
                    break
                msgs += resp["messages"]
                offset = resp["next_offset"]
            out[p] = (msgs, offset)
        if host_workers > 1:
            ctrl = next(b for b in c.brokers.values()
                        if b.hostplane is not None
                        and b.dataplane is not None)
            hp = ctrl.dispatch({"type": "admin.stats"})["host_plane"]
            out["workers"] = hp["workers"]
    return out


def test_host_plane_committed_prefix_equals_reference_single_process():
    want = _drive_cluster("ripplemq_tpu", 1)
    got = _drive_cluster("ripplemq_tpu_torch", 2)
    assert got.pop("workers") == 2
    assert got == want
    n = sum(i % 4 + 1 for i in range(8))
    assert [len(got[p][0]) for p in (0, 1)] == [n, n]
