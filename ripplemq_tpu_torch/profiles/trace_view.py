"""Causal-trace viewer: sampled produce/consume critical-path trees.

The collection + attribution surface of the tracing plane (obs/spans.py
for the rings and wire propagation, obs/assemble.py for the skew model
and tree join). Two modes:

1. Live demo (default): boot an in-proc 3-broker cluster with tracing
   on (`trace_sample_n=1` — every call sampled), run a few produces and
   consumes, page every broker's `admin.spans` ring, merge in the
   client rings, assemble, and render each trace as an attributed tree:

       trace 0x... root=client.produce ack=1.9ms coverage=96% ...
           +0.000ms client.produce  ...
           +0.115ms rpc.recv        ...  [broker0]
           ...

   `--host-workers N` boots the multi-core host plane so the trees
   include the shm-ring worker hop (worker.serve/validate/stamp/pack in
   the worker subprocess's own clock domain); `--striped` switches
   replication to the striped plane (stripe.send/stripe.apply spans).
   Every broker's device work runs on CUDA unless `--device cpu` is
   given; without a GPU the live demo raises.

2. Offline (`--from-json FILE`): render traces from records on disk —
   either a bare JSON list of span records, or a chaos verdict (the
   harness embeds every postmortem bundle's span ring under
   `postmortems.*.spans` and its own assembled `traces`). This mode
   reads a file only and needs no device.

No wall clocks anywhere: every placement is in the root span's
monotonic domain via the assembler's NTP-style per-process offsets.

Run: python -m ripplemq_tpu_torch.profiles.trace_view
     python -m ripplemq_tpu_torch.profiles.trace_view --host-workers 2 --striped
     python -m ripplemq_tpu_torch.profiles.trace_view --from-json verdict.json

Twin of the reference's `profiles/trace_view.py` over the port's
cluster, clients and `obs/assemble.py`.
"""

from __future__ import annotations

import argparse
import json
import sys


def collect_spans(client, addrs: list[str],
                  page: int = 512) -> list[dict]:
    """Page every broker's admin.spans ring to exhaustion (the cursor
    contract: `after` = last seq seen, stop when the cursor holds)."""
    records: list[dict] = []
    for addr in addrs:
        after = -1
        while True:
            resp = client.call(addr, {"type": "admin.spans",
                                      "after": after,
                                      "max_spans": page}, timeout=10.0)
            if not resp.get("ok") or not resp.get("spans"):
                break
            records.extend(resp["spans"])
            if resp.get("cursor", after) == after:
                break
            after = resp["cursor"]
    return records


def demo_config(host_workers: int = 1, striped: bool = False):
    """The live demo's cluster: 3 brokers with every call sampled, at
    `make_cluster_config`'s default topics and engine."""
    from ripplemq_tpu_torch.chaos.cluster import make_cluster_config

    kw = dict(obs=True, trace_sample_n=1)
    if host_workers > 1:
        kw["host_workers"] = host_workers
    if striped:
        kw["replication"] = "striped"
    return make_cluster_config(n_brokers=3, **kw)


def live_spans(messages: int = 5, host_workers: int = 1,
               striped: bool = False, device: str | None = None) -> list[dict]:
    """The live demo's span records: `demo_config`'s cluster, `messages`
    produces and one consume, every broker's ring and both clients'
    rings. `device`: every broker's (CUDA when None; raises without a
    GPU)."""
    from ripplemq_tpu_torch.chaos.cluster import InProcCluster
    from ripplemq_tpu_torch.client.consumer import ConsumerClient
    from ripplemq_tpu_torch.client.producer import ProducerClient

    with InProcCluster(demo_config(host_workers, striped),
                       device=device) as cluster:
        cluster.wait_for_leaders()
        prod = ProducerClient(
            [cluster.broker_addr(0)], transport=cluster.client("p"),
            trace_sample_n=1, producer_name="producer/view")
        cons = ConsumerClient(
            [cluster.broker_addr(0)], "consumer/view",
            transport=cluster.client("c"), trace_sample_n=1)
        for i in range(messages):
            prod.produce("topic1", b"m%d" % i, partition=0)
        cons.consume("topic1", partition=0, max_messages=messages)
        records = collect_spans(
            cluster.client("spans"),
            [cluster.broker_addr(b) for b in cluster.brokers])
        records += prod.spans.snapshot()
        records += cons.spans.snapshot()
        prod.close()
        cons.close()
    return records


def spans_from_json(path: str) -> list[dict]:
    """Span records on disk: a bare list, or a chaos verdict's
    postmortem bundles' rings."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return doc
    return [r for pm in (doc.get("postmortems") or {}).values()
            for r in pm.get("spans") or ()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--messages", type=int, default=5,
                    help="sampled produces to run in live mode")
    ap.add_argument("--host-workers", type=int, default=1,
                    help="boot the multi-core host plane (worker hop "
                         "spans cross the shm ring)")
    ap.add_argument("--striped", action="store_true",
                    help="striped replication (stripe.send/apply spans)")
    ap.add_argument("--from-json", default=None, metavar="FILE",
                    help="render span records (or a chaos verdict's "
                         "postmortem spans) from disk instead")
    ap.add_argument("--json", action="store_true",
                    help="emit assembled trees as JSON, not rendered")
    ap.add_argument("--device", default=None,
                    help="torch device for the live demo's brokers "
                         "(default CUDA; 'cpu' runs them on the CPU)")
    args = ap.parse_args(argv)

    from ripplemq_tpu_torch.obs.assemble import assemble, render

    if args.from_json:
        records = spans_from_json(args.from_json)
    else:
        records = live_spans(args.messages, args.host_workers, args.striped,
                             args.device)
    trees = assemble(records)
    if args.json:
        print(json.dumps(trees, indent=2, default=str))
        return 0
    print(f"{len(records)} span records -> {len(trees)} trace(s)")
    for tree in trees:
        print()
        print(render(tree))
    return 0


if __name__ == "__main__":
    sys.exit(main())
