"""A load-generator process: `python -m mqbench.loadgen SPEC.json`.

It drives the cluster through the port's client SDK alone
(`ProducerClient.produce_batch_async`, `ConsumerClient.
consume_with_position`) and loads no torch, so its interpreter is billed
to the client side, as a user's would be. The harness talks to it over a
line protocol on stdin/stdout:

    -> READY                       clients connected
    <- GO <t0_ns> <ws_ns> <we_ns>  traffic from t0; the window [ws, we)
    -> DONE                        (producers) every request answered;
                                   results written to the spec's `out`
    <- PROBE                       (a producer) one one-message request
                                   to every partition, all at once
    -> DONE                        every probe answered; results rewritten
    <- DRAIN                       (tail readers) producers are done:
                                   read every partition to its end
    -> DONE                        results written to the spec's `out`
    <- EXIT

Roles: `producer` (a closed loop of windowed threads, paced at the mix's
rate, or one open-loop schedule) and `tail` (reader threads following
every partition's end). Times are CLOCK_MONOTONIC nanoseconds, which
every process on the host shares.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque

import numpy as np

from mqbench import traffic


def _now() -> int:
    return time.monotonic_ns()


def _sleep_until(t_ns: int) -> None:
    while True:
        d = t_ns - _now()
        if d <= 0:
            return
        time.sleep(min(d / 1e9, 0.05))


def _stamping_transport():
    """The SDK's TCP transport, stamping the arrival of every produce
    answer (the request's stream and k ride in its first message's
    header), so an ack is timed when it lands, not when a thread gets
    round to reading it."""
    from ripplemq_tpu_torch.wire.transport import TcpClient

    class StampingTcpClient(TcpClient):
        def __init__(self) -> None:
            super().__init__()
            self.acked: dict = {}

        def call_async(self, addr, request):
            fut = super().call_async(addr, request)
            if request.get("type") == "produce":
                head = request["messages"][0]
                key = (int.from_bytes(head[8:12], "little"),
                       int.from_bytes(head[12:16], "little"))

                def stamp(f, key=key) -> None:
                    if not f.cancelled() and f.exception() is None \
                            and f.result().get("ok"):
                        self.acked[key] = _now()

                fut.add_done_callback(stamp)
            return fut

    return StampingTcpClient()


class Producer:
    def __init__(self, spec: dict) -> None:
        from ripplemq_tpu_torch.client.producer import ProducerClient

        self.spec = spec
        self.pl = traffic.Payloads(spec["seed"], spec["size"])
        self.tp = _stamping_transport()
        self.pc = ProducerClient(spec["bootstrap"], transport=self.tp,
                                 rpc_timeout_s=spec["rpc_timeout_s"])
        self.lock = threading.Lock()
        self.acks: list = []    # stream, k, part, base, n, due, sent, ack
        self.failed: list = []  # stream, k, part, n, due
        self.errors: list = []
        self.start = traffic.closed_start(spec["seed"], spec["partitions"])

    def _land(self, stream, k, part, n, due, sent, wait) -> None:
        try:
            base = wait()
        except Exception as e:  # counted as failed, never as acked
            with self.lock:
                self.failed.append((stream, k, part, n, due))
                self.errors.append(repr(e)[:200])
            return
        ack = self.tp.acked.pop((stream, k), None) or _now()
        with self.lock:
            self.acks.append((stream, k, part, base, n, due, sent, ack))

    def _send(self, stream, k, part, n, due):
        msgs = self.pl.make(due, stream, k, part, n)
        sent = _now()
        return sent, self.pc.produce_batch_async(self.spec["topic"], msgs,
                                                 partition=part)

    def closed_thread(self, stream: int, t0: int, we: int) -> None:
        """Requests of `batch` messages, at most `in_flight` unanswered,
        each sent no earlier than the stream's share of the mix's rate
        allows: paced while the cluster keeps up, a closed loop once it
        does not."""
        s = self.spec
        pending: deque = deque()
        k = 0
        gap_ns = s["batch"] * s["total_streams"] * 1e9 / s["rate_msgs_per_s"]
        try:
            while _now() < we:
                while len(pending) >= s["in_flight"]:
                    self._land(*pending.popleft())
                _sleep_until(t0 + int(k * gap_ns))
                part = (self.start + stream + k * s["total_streams"]) \
                    % s["partitions"]
                due = _now()
                sent, w = self._send(stream, k, part, s["batch"], due)
                pending.append((stream, k, part, s["batch"], due, sent, w))
                k += 1
        except Exception as e:
            with self.lock:
                self.errors.append(repr(e)[:200])
        while pending:
            self._land(*pending.popleft())

    def open_loop(self, t0: int) -> None:
        s = self.spec
        sched = traffic.open_schedule(s["traffic"], s["partitions"],
                                      s["seed"], s["schedule_seconds"])
        mine = np.arange(s["proc"], len(sched["n"]), s["procs"])
        q: deque = deque()
        done = threading.Event()
        cv = threading.Condition()

        def collect() -> None:
            while True:
                with cv:
                    while not q and not done.is_set():
                        cv.wait(0.1)
                    if not q:
                        return
                    item = q.popleft()
                self._land(*item)

        col = [threading.Thread(target=collect, name=f"mqbench-ack-{i}",
                                daemon=True) for i in range(8)]
        for c in col:
            c.start()
        stream = s["proc"]
        try:
            for i in mine:
                due = t0 + int(sched["due_s"][i] * 1e9)
                _sleep_until(due)
                part, n = int(sched["part"][i]), int(sched["n"][i])
                sent, w = self._send(stream, int(i), part, n, due)
                with cv:
                    q.append((stream, int(i), part, n, due, sent, w))
                    cv.notify()
        except Exception as e:
            with self.lock:
                self.errors.append(repr(e)[:200])
        done.set()
        with cv:
            cv.notify_all()
        for c in col:
            c.join()

    def run(self, t0: int, ws: int, we: int) -> None:
        s = self.spec
        if s["loop"] == "open":
            self.open_loop(t0)
        else:
            _sleep_until(t0)
            ts = [threading.Thread(target=self.closed_thread,
                                   args=(st, t0, we),
                                   name=f"mqbench-producer-{st}")
                  for st in s["streams"]]
            for t in ts:
                t.start()
            for t in ts:
                t.join()

    def probe(self) -> None:
        """One one-message request to every partition, sent at once on
        a stream of their own; returns when each is answered."""
        s = self.spec
        sent = []
        for part in range(s["partitions"]):
            due = _now()
            t, w = self._send(traffic.PROBE_STREAM, part, part, 1, due)
            sent.append((traffic.PROBE_STREAM, part, part, 1, due, t, w))
        for item in sent:
            self._land(*item)

    def write(self, path: str) -> None:
        np.savez(path,
                 acks=np.array(self.acks, np.int64).reshape(-1, 8),
                 failed=np.array(self.failed, np.int64).reshape(-1, 5))
        with open(path + ".json", "w") as f:
            json.dump({"errors": self.errors[:20]}, f)

    def close(self) -> None:
        self.pc.close()


class Readers:
    """Tail reader threads, one ConsumerClient each."""

    def __init__(self, spec: dict) -> None:
        self.spec = spec
        self.pl = traffic.Payloads(spec["seed"], spec["size"])
        self.lock = threading.Lock()
        self.drain = threading.Event()
        self.stop = threading.Event()
        self.errors: list = []
        self.corrupt = self.misrouted = 0
        self.ids: dict = {}     # tail: part -> [id arrays]
        self.lat_ms: list = []  # tail: delivery latency of window messages
        self.in_window = 0      # messages received inside the window

    def _client(self, cid: str):
        from ripplemq_tpu_torch.client.consumer import ConsumerClient

        return ConsumerClient(self.spec["bootstrap"], cid,
                              max_messages=self.spec["read_batch"],
                              rpc_timeout_s=self.spec["rpc_timeout_s"],
                              prefetch=1)

    def _take(self, part, msgs, t, ws, we):
        ids, due, hpart, ok = self.pl.verify(msgs)
        bad = int((~ok).sum())
        mis = int((ok & (hpart != part)).sum())
        lat = None
        sel = ok & (due >= ws) & (due < we)
        if sel.any():
            lat = ((t - due[sel].astype(np.int64)) / 1e6).astype(np.float64)
        with self.lock:
            self.corrupt += bad
            self.misrouted += mis
            if ws <= t < we:
                self.in_window += len(msgs)
            if lat is not None:
                self.lat_ms.append(lat)
        return ids

    def tail_thread(self, idx: int, ws: int, we: int) -> None:
        s = self.spec
        mine = list(range(idx, s["partitions"], s["threads"]))
        cc = self._client(f"{s['name']}-c{idx}")
        got = {p: [] for p in mine}
        try:
            while True:
                draining = self.drain.is_set()
                empty = True
                for p in mine:
                    msgs, _, _, _ = cc.consume_with_position(
                        s["topic"], partition=p)
                    if msgs:
                        empty = False
                        got[p].append(self._take(p, msgs, _now(), ws, we))
                if (draining and empty) or self.stop.is_set():
                    break
        except Exception as e:
            with self.lock:
                self.errors.append(repr(e)[:200])
        finally:
            cc.close()
        with self.lock:
            for p, arrs in got.items():
                self.ids[p] = arrs

    def run(self, t0: int, ws: int, we: int) -> list:
        _sleep_until(t0)
        ts = [threading.Thread(target=self.tail_thread, args=(i, ws, we),
                               name=f"mqbench-reader-{i}")
              for i in range(self.spec["threads"])]
        for t in ts:
            t.start()
        return ts

    def write(self, path: str) -> None:
        parts, ids = [], []
        for p, arrs in sorted(self.ids.items()):
            if arrs:
                a = np.concatenate(arrs)
                ids.append(a)
                parts.append(np.full(len(a), p, np.int32))
        lat = (np.concatenate(self.lat_ms) if self.lat_ms
               else np.zeros(0, np.float64))
        np.savez(path,
                 ids=np.concatenate(ids) if ids else np.zeros(0, np.uint64),
                 parts=(np.concatenate(parts) if parts
                        else np.zeros(0, np.int32)),
                 lat_ms=lat)
        info = {"errors": self.errors[:20], "corrupt": self.corrupt,
                "misrouted": self.misrouted, "in_window": self.in_window}
        with open(path + ".json", "w") as f:
            json.dump(info, f)


def main(argv: list[str]) -> int:
    with open(argv[0]) as f:
        spec = json.load(f)
    role = Producer(spec) if spec["role"] == "producer" else Readers(spec)
    print("READY", flush=True)
    threads: list = []
    for line in sys.stdin:
        cmd = line.split()
        if not cmd:
            continue
        if cmd[0] == "GO":
            t0, ws, we = (int(x) for x in cmd[1:4])
            if isinstance(role, Producer):
                role.run(t0, ws, we)
                role.write(spec["out"])
                print("DONE", flush=True)
            else:
                threads = role.run(t0, ws, we)
        elif cmd[0] == "PROBE":
            role.probe()
            role.write(spec["out"])
            print("DONE", flush=True)
        elif cmd[0] == "DRAIN":
            role.drain.set()
            for t in threads:
                t.join(timeout=float(cmd[1]) if len(cmd) > 1 else None)
            role.stop.set()
            for t in threads:
                t.join()
            role.write(spec["out"])
            print("DONE", flush=True)
        elif cmd[0] == "EXIT":
            break
    if isinstance(role, Producer):
        role.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
