"""The plain reference: a per-partition append log, and the comparison.

Plain Python and NumPy; imports nothing of the program. It rebuilds what
each partition's log must hold from what the load generators sent and
were acked, and holds every copy the run read back against it: the
messages the consumers received from the leader and the rows each
standby's store holds.

The guarantees it checks are the configuration's: every acked message
is delivered to a consumer once, byte for byte, in the order of its
partition's log; no message is delivered that was never acked; and every
acked message is held by at least `min_insync` replicas (the leader's
log, read back through the consumer, and each standby's store).
"""

from __future__ import annotations

import numpy as np

from mqbench.traffic import request_ids

# Every number the comparison reports, in the order it prints them. Each
# has the limit 0: the comparison is exact.
COUNTS = ("failed_requests", "overlapping_acks", "corrupt", "misrouted",
          "missing", "duplicated", "never_acked", "reordered",
          "under_replicated", "standby_extra")


def expected_logs(acks: list) -> tuple[dict, int]:
    """Per-partition message ids in log order, from acked requests
    (stream, k, part, base_offset, n), and the number of requests whose
    offset ranges overlap another's in the same partition (a log cannot
    hold two batches at one offset)."""
    by_part: dict[int, list] = {}
    for stream, k, part, base, n in acks:
        by_part.setdefault(int(part), []).append(
            (int(base), int(n), int(stream), int(k)))
    logs, overlaps = {}, 0
    for part, reqs in by_part.items():
        reqs.sort()
        end = -1
        for base, n, _, _ in reqs:
            if base < end:
                overlaps += 1
            end = max(end, base + n)
        logs[part] = (np.concatenate([request_ids(s, k, n)
                                      for _, n, s, k in reqs])
                      if reqs else np.zeros(0, np.uint64))
    return logs, overlaps


def _order_breaks(got: np.ndarray, want: np.ndarray) -> int:
    """Messages of `got` (each in `want`, once) that come before one
    they follow in `want`: 0 iff got is in want's order."""
    if len(got) < 2:
        return 0
    pos = np.searchsorted(want, got, sorter=np.argsort(want))
    order = np.argsort(want)[pos]
    return int((np.diff(order) < 0).sum())


def compare_partition(want: np.ndarray, got: np.ndarray) -> dict:
    """Delivered ids `got` of one partition against its log `want`."""
    uniq, counts = np.unique(got, return_counts=True)
    in_want = np.isin(uniq, want)
    dup = int((counts[in_want] - 1).sum())
    never = int(counts[~in_want].sum())
    missing = int((~np.isin(want, uniq)).sum())
    keep = got[np.isin(got, want)]
    if dup:
        _, first = np.unique(keep, return_index=True)
        keep = keep[np.sort(first)]
    return {"missing": missing, "duplicated": dup, "never_acked": never,
            "reordered": _order_breaks(keep, want)}


def check_run(acks: list, failed: int, deliveries: dict, delivery_faults:
              dict, standbys: list, min_insync: int) -> dict:
    """The whole comparison of one run.

    `acks`: (stream, k, part, base_offset, n) per acked request;
    `failed`: requests that were sent and never acked;
    `deliveries`: partition -> ids the tail consumers received, in order;
    `delivery_faults`: {"corrupt": n, "misrouted": n} from the consumers'
    byte checks (`traffic.Payloads.verify`);
    `standbys`: per standby, partition -> ids its store holds, in log
    order (with `corrupt`/`misrouted` under the key None).
    Returns every count of COUNTS; a run is correct iff all are 0."""
    logs, overlaps = expected_logs(acks)
    out = dict.fromkeys(COUNTS, 0)
    out["failed_requests"] = int(failed)
    out["overlapping_acks"] = overlaps
    out["corrupt"] = int(delivery_faults.get("corrupt", 0))
    out["misrouted"] = int(delivery_faults.get("misrouted", 0))
    for part in set(logs) | set(deliveries):
        want = logs.get(part, np.zeros(0, np.uint64))
        got = np.asarray(deliveries.get(part, np.zeros(0, np.uint64)),
                         np.uint64)
        for key, v in compare_partition(want, got).items():
            out[key] += v
    for held in standbys:
        faults = held.get(None, {})
        out["corrupt"] += int(faults.get("corrupt", 0))
        out["misrouted"] += int(faults.get("misrouted", 0))
    for part, want in logs.items():
        copies = np.isin(want, np.asarray(deliveries.get(part, []),
                                          np.uint64)).astype(np.int64)
        for held in standbys:
            have = np.asarray(held.get(part, []), np.uint64)
            copies += np.isin(want, have)
            # A standby holds the leader's log: acked rows, and rows of
            # requests that committed but whose ack never came (counted
            # under failed_requests). Anything else is foreign.
            if failed == 0:
                out["standby_extra"] += int((~np.isin(have, want)).sum())
        out["under_replicated"] += int((copies < min_insync).sum())
    return out

