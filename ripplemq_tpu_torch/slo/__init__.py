"""SLO autopilot: closed-loop overload control for the broker host path.

The obs plane is the diagnosis plane (stage-latency histograms, stall
streaks, retry budgets, the flight recorder); this package is the
REACTION — the "diagnosis and reaction built into the system" step
MegaScale (arXiv:2402.15627, PAPERS.md) argues a production system
needs beyond dashboards:

- `slo/controller.py` — SloController: a per-broker control thread
  that reads the live metrics registry every `slo_tick_s` and adjusts
  the operating knobs (`read_coalesce_s`, chain depth, settle window)
  AIMD-style against a configured `slo_p99_ack_ms` target, bounded by
  ClusterConfig rails, every decision emitted as a closed-vocabulary
  trace event. It also runs the shed state machine: settle-window
  occupancy, stall streaks, quorum degradation, or a sustained hard
  p99 breach engage load shedding; a hysteresis window of clean ticks
  disengages it.
- `slo/admission.py` — per-tenant token-bucket quotas plus the shed
  gate, consulted at the TOP of the produce RPC surface: a refused
  produce costs a dict lookup, never payload packing or a worker-ring
  hop. Refusals are the typed retryable `overloaded:` error
  (wire/retry.py), so clients back off instead of hammering an
  overloaded broker.

Lazy exports (PEP 562) to keep the worker-subprocess import path thin,
matching the package convention.

Twin of `ripplemq_tpu/slo/__init__.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

_EXPORTS = {
    "SloController": ("ripplemq_tpu_torch.slo.controller", "SloController"),
    "AdmissionController": ("ripplemq_tpu_torch.slo.admission",
                            "AdmissionController"),
    "TokenBucket": ("ripplemq_tpu_torch.slo.admission", "TokenBucket"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
