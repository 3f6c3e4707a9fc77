"""Admission control: per-tenant token buckets + the shed gate.

The produce RPC surface calls `admit()` FIRST — before partition
resolution, payload validation, pid stamping, packing, or a
worker-ring hop — so a refusal under overload costs one dict lookup
and one refill computation, not the work the refusal exists to avoid.

Tenancy is the producer-name prefix: the SDK registers names like
`tenant/instance-nonce` (ProducerClient `producer_name`), and the
segment before the first "/" is the tenant key. `ClusterConfig.
slo_quotas` maps tenant → messages/second; a quota is both a CAP
(the bucket refuses a tenant exceeding its rate even when the broker
is healthy) and a PRIORITY CLAIM (while the shed state machine is
engaged, quota-holding tenants keep their admission up to their
buckets and everyone else — the best-effort tier, including pid-less
raw produces — is refused). Refusals carry the typed retryable
`overloaded:` prefix so clients jitter-backoff-and-retry instead of
hammering the refusal path (wire/retry.py).

The shed gate is a LADDER, not a switch (`slo_tenant_tiers`):

- **Level 0** — steady state. Quota caps only.
- **Level 1** — shed engaged. Best-effort traffic (tenants holding
  neither a quota nor a tier entry, including anonymous produces) is
  refused; every tiered/quota-holding tenant still admits through its
  bucket.
- **Level 2** — escalation (the controller holds the shed through
  `ESCALATE_STREAK` more evidencing ticks, slo/controller.py).
  "low"-tier tenants are refused too; only "high"-tier tenants keep
  admission, up to their buckets.

Tenants absent from the tier table default to "high" — the exact
pre-tier behavior, where every quota holder rode out a shed. The
ladder exists so a broker under sustained overload keeps degrading
in priority order instead of choosing between "refuse nobody with a
quota" and "refuse everybody".

Quotas are CLUSTER-LEVEL: each broker scales its per-tenant bucket
rate by its share of partition leaderships (`set_leadership_share`,
pushed by BrokerServer._quota_share_duty), so a tenant producing to
every leader sums to ~its configured rate regardless of broker count —
the pre-scaling behavior multiplied the quota by the number of
partition-leader brokers. The share is floored at one partition's
worth by the duty: a broker holding ZERO leaderships still admits a
trickle, so a stale-routed produce draws the proper `not_leader`
redirect hint instead of an `overloaded:` refusal (admission runs
before the leadership check). The clock is injectable so tier-1 tests
drive refill windows with zero real sleeps.

Twin of `ripplemq_tpu/slo/admission.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ripplemq_tpu_torch.obs.lockwitness import make_lock


class TokenBucket:
    """One tenant's rate state: `rate` tokens/s refill, burst capacity
    of one second's worth (min 1). take() is called under the
    admission lock — no internal locking.

    DEBT model for oversize requests: a request is admitted whenever
    the bucket is positive and charges its FULL size, letting the
    balance go negative — the tenant then waits out the debt at the
    refill rate. Requiring `tokens >= n` instead would make any batch
    larger than one second's rate UNSATISFIABLE BY CONSTRUCTION: the
    balance caps at `burst`, so the 'retry with backoff' refusal would
    livelock a healthy in-quota tenant forever. Debt preserves the
    long-run rate exactly; it just lets one batch front-load it."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, now: float) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, self.rate)
        self.tokens = self.burst
        self.t = now

    def take(self, n: int, now: float) -> bool:
        if now > self.t:
            self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
            self.t = now
        if self.tokens > 0:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """The produce front door. `admit()` returns None (admitted) or a
    human-readable refusal reason the caller wraps as `overloaded: …`.

    The no-quota, not-shedding fast path is two attribute reads and a
    bool test — the cost every produce pays when the autopilot has
    nothing to say."""

    def __init__(self, quotas: dict[str, float],
                 clock: Callable[[], float] = time.monotonic,
                 tiers: Optional[dict[str, str]] = None) -> None:
        self._clock = clock
        self._lock = make_lock("AdmissionController._lock")
        self._quotas = {str(k): float(v) for k, v in dict(quotas or {}).items()}
        self._tiers = {str(k): str(v) for k, v in dict(tiers or {}).items()}
        self._buckets: dict[str, TokenBucket] = {}
        # Leadership share: the fraction of the cluster's partition
        # leaderships this broker holds — each tenant bucket's
        # effective rate is quota * share, making the quota a CLUSTER
        # rate instead of a per-broker one. 1.0 until the duty's first
        # push (single-broker and test shapes keep full rate).
        self._share = 1.0
        self._shed_level = 0
        # Counters (racy-read snapshot contract, like obs.metrics):
        # written under _lock, read bare by stats().
        self.shed_refusals = 0
        self.quota_refusals = 0

    @property
    def shedding(self) -> bool:
        return self._shed_level > 0

    @property
    def shed_level(self) -> int:
        return self._shed_level

    def set_leadership_share(self, share: float) -> None:
        """Rescale every tenant bucket to `quota * share` (share = this
        broker's fraction of partition leaderships, pushed by the
        owning broker's duty pass as leadership moves). Existing
        buckets rescale IN PLACE — their balance clips to the new
        burst so a failover that shrinks a broker's share cannot leave
        a banked full-cluster burst behind; accumulated debt (negative
        balance) is preserved."""
        share = max(0.0, min(1.0, float(share)))
        with self._lock:
            if share == self._share:
                return
            self._share = share
            for tenant, b in self._buckets.items():
                rate = self._quotas[tenant] * share
                b.rate = rate
                b.burst = max(1.0, rate)
                b.tokens = min(b.tokens, b.burst)

    @property
    def leadership_share(self) -> float:
        return self._share

    def set_shed(self, on: bool) -> None:
        """Switch-shaped compatibility surface: on = ladder level 1."""
        self.set_shed_level(1 if on else 0)

    def set_shed_level(self, level: int) -> None:
        with self._lock:
            self._shed_level = max(0, min(2, int(level)))

    def tier_of(self, tenant: str) -> str:
        """"high" / "low" / "best_effort". A tenant holding a quota or a
        tier entry is prioritized; an explicit tier wins; a quota holder
        with no tier entry defaults to "high" (pre-ladder behavior)."""
        t = self._tiers.get(tenant)
        if t is not None:
            return t
        return "high" if tenant in self._quotas else "best_effort"

    @staticmethod
    def tenant_of(producer_name: Optional[str]) -> str:
        """Producer-name prefix before the first "/" ("" for pid-less /
        anonymous produces — always the best-effort tier)."""
        if not producer_name:
            return ""
        return str(producer_name).split("/", 1)[0]

    def admit(self, producer_name: Optional[str], n: int) -> Optional[str]:
        """None = admitted. A string = refusal reason (the caller emits
        it under the retryable `overloaded:` prefix)."""
        if self._shed_level == 0 and not self._quotas:
            return None  # autopilot quiet: zero-cost front door
        tenant = self.tenant_of(producer_name)
        with self._lock:
            level = self._shed_level
            if level > 0:
                tier = self.tier_of(tenant)
                if tier == "best_effort" or (level >= 2 and tier == "low"):
                    self.shed_refusals += 1
                    what = ("best-effort" if tier == "best_effort"
                            else "'low'-tier")
                    return (f"shedding {what} traffic (tenant "
                            f"{tenant or '<anonymous>'!r}, shed level "
                            f"{level}); retry with backoff")
            rate = self._quotas.get(tenant)
            if rate is None:
                return None
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(
                    rate * self._share, self._clock()
                )
            if b.take(max(1, int(n)), self._clock()):
                return None
            self.quota_refusals += 1
            return (f"tenant {tenant!r} over its {rate:g} msg/s cluster "
                    f"quota (this broker's share "
                    f"{rate * self._share:g} msg/s); retry with backoff")

    def stats(self) -> dict:
        return {
            "shedding": self._shed_level > 0,
            "shed_level": self._shed_level,
            "leadership_share": self._share,
            "quota_tenants": len(self._quotas),
            "tier_tenants": len(self._tiers),
            "shed_refusals": self.shed_refusals,
            "quota_refusals": self.quota_refusals,
        }
