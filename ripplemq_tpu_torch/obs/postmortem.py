"""One-shot postmortem bundles: everything a term-skew diagnosis
needed, collected in one RPC instead of a hand-rolled probe session.

A term-skew wedge is identified by noticing `ctrl_table_term=[5,5]` vs
`device_current_terms=[8,8]` with thousands of dispatches and zero
commits — each number pulled through a different ad-hoc reach-in. This
module packages that exact cross-section (control tables vs device
scalars, log ends, stall streaks, settled gaps, settle-window occupancy,
degraded/quarantine flags, retry budgets) plus the recent flight-
recorder window into a single wire-encodable dict, served by every
broker as `admin.postmortem` (frontends return the broker-level slice
with `engine: None`).

The engine section costs one device-lock hold spanning three
state-leaf fetches (terms, commits, log ends) — a deliberate price for
a ONE-SHOT diagnosis RPC, not a polling surface; `admin.stats` remains
the cheap periodic poll.

Twin of `ripplemq_tpu/obs/postmortem.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import time


def collect_postmortem(broker, trace_last: int = 256) -> dict:
    """Build one broker's postmortem bundle. `broker` is a BrokerServer;
    the bundle is wire-encodable (served verbatim by admin.postmortem)."""
    node = broker.runner.node
    dp = broker._local_engine()
    bundle = {
        "ok": True,
        "broker": broker.broker_id,
        "address": broker.addr,
        "t": time.time(),
        "boot_failures": broker._boot_failures,
        "store_quarantined": broker._store_quarantined,
        "metadata": {
            "role": node.role,
            "term": node.term,
            "leader_hint": node.leader_hint,
        },
        "controller": {
            "id": broker.manager.current_controller(),
            "epoch": broker.manager.current_epoch(),
            "standbys": list(broker.manager.current_standbys()),
            "is_self": broker.is_controller,
        },
        "live": list(broker.manager.live),
        "duty_errors": list(broker.duty_errors),
        "engine": dp.postmortem() if dp is not None else None,
        "metrics": broker.metrics.snapshot(),
        "trace": broker.recorder.snapshot(last=trace_last),
        # The causal-tracing ring (obs/spans.py), empty when sampling is
        # off — a postmortem's sampled traces reassemble into critical-
        # path trees with obs/assemble.py (chaos verdicts attach them).
        "spans": (broker.spans.snapshot() if broker.spans is not None
                  else []),
    }
    if dp is not None and dp.recorder is not broker.recorder:
        # An externally-injected plane keeps its own recorder; its round
        # lifecycle is part of the story, so ship both windows.
        bundle["engine_trace"] = dp.recorder.snapshot(last=trace_last)
    if dp is not None and dp.metrics is not broker.metrics:
        bundle["engine_metrics"] = dp.metrics.snapshot()
    return bundle
