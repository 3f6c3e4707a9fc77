"""SloController: the closed loop from live telemetry to operating knobs.

One controller per broker. Every `slo_tick_s` it:

1. **Measures** the tick window's produce-ack p99 by differencing the
   `produce.ack_us` histogram's log2 bins against the previous tick's
   snapshot (obs/metrics.py histograms are cumulative; the delta is the
   window distribution — factor-of-2 resolution, which is what a
   control loop comparing against a latency target needs).
2. **Adjusts** (controller broker only — the knobs live on the device
   plane): AIMD against `slo_p99_ack_ms`. A breach halves the
   latency-costly knobs (multiplicative decrease: `read_coalesce_s`,
   chain depth, the settle window's soft bound); a comfortable window
   (p99 ≤ half the target) walks them back toward throughput
   (additive: one coalesce step / one window slot; chain depth moves
   on a power-of-two ladder because each distinct depth is its own
   compiled device program — the ladder bounds runtime compiles to
   log2(max) programs). Everything clamps to the ClusterConfig rails
   (`slo_read_coalesce_min/max_s`, `slo_chain_depth_min/max`,
   `slo_settle_window_min`). Every applied change is a `slo_adjust`
   flight-recorder event, so postmortems carry the control timeline.
3. **Decides shedding**: quorum degradation or a stall
   streak engages immediately; the sampled/integrated signals need 2
   evidencing ticks within the last 5 (not necessarily consecutive —
   see the evidence-window constants below) — settle-window occupancy
   at ≥
   `slo_shed_occupancy` of the effective window OR a settle-enqueue
   backpressure event since the last tick (the COUNTER DELTA, not the
   instantaneous depth: a stall shorter than one tick still leaves its
   increments behind, where a sampled gauge reads clean between
   ticks), or a settle-stage FAILURE since the last tick
   (`step_errors` delta — the empty-standby-set refusal state shows
   up here even when membership heals between ticks). A p99 breach
   alone deliberately does NOT shed: shedding helps when the pipe is
   QUEUEING (refusing work drains it), and a breach with an empty
   settle window is structural slowness — boot-time compiles, the
   worker-hop floor on a starved host — where refusing best-effort
   traffic forever fixes nothing (observed exactly so while driving
   this: a 2-core host_workers=2 boot breached a 50 ms target at zero
   occupancy and shed-flapped a perfectly healthy cluster). The p99
   window drives the AIMD law instead. Consequence, stated plainly:
   every shed signal is engine-side, so shedding engages at the
   CONTROLLER broker's produce surface; a non-controller partition
   leader's produces feel the overload as engine-append backpressure
   rather than an early refusal (a frontend-local shed signal that
   cannot false-positive on structural slowness is a ROADMAP
   residual). ALL conditions must stay clear for 3 consecutive ticks
   before shedding disengages (hysteresis — flapping admission is
   worse than either steady state). Transitions emit
   `slo_shed_on`/`slo_shed_off` and flip the admission controller's
   shed gate (slo/admission.py).

**Consume twin** (`slo_p99_consume_ms`): the same loop measures the
consume-ack window p99 off `consume.ack_us` and AIMD-steers
`read_coalesce_s` — the one knob on the consume ack path — against the
consume target. A consume breach always halves it (latency wins);
the additive walk-back is suppressed while the PRODUCE loop is in
breach so the two laws never fight over the shared knob. Either target
alone starts the control thread; with both set, the produce law runs
first each tick and the consume law reads the post-adjust knob state.

The clock and the tick driver are injectable: tier-1 tests construct
the controller without starting the thread and call `tick()` against a
scripted metrics feed and a fake plane — zero real sleeps. The thread
only starts when `slo_p99_ack_ms > 0` or `slo_p99_consume_ms > 0`
(either is config-validated to require the metrics registry).

Twin of `ripplemq_tpu/slo/controller.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from ripplemq_tpu_torch.obs.lockwitness import make_lock
from ripplemq_tpu_torch.slo.admission import AdmissionController
from ripplemq_tpu_torch.utils.logs import get_logger

log = get_logger("slo")

# Shed-machine shape: evidence-window lengths for the noisy signals
# and the all-clear hysteresis window.
# Deliberately NOT config knobs: they parameterize the controller's
# stability, not the deployment's SLO — a deployment tunes the target,
# the rails, and the tick, and gets a controller that cannot flap.
# Noisy-signal evidence window: the sampled/integrated shed signals
# engage on >= EVIDENCE_MIN evidencing ticks within the last
# EVIDENCE_WINDOW ticks (client backoff SPACES the symptoms of a
# sustained fault out — refused rounds arrive at the retry cadence,
# not every tick — so a consecutive-streak rule reads a persistent
# outage as a series of one-off blips and never fires).
EVIDENCE_WINDOW = 5
EVIDENCE_MIN = 2
CLEAR_STREAK = 3
# Shed-LADDER escalation: after the shed engages (level 1, best-effort
# refused), this many FURTHER evidencing ticks escalate to level 2
# ("low"-tier quota holders refused too, slo/admission.py). Recovery
# walks back down the same ladder one level per CLEAR_STREAK — the
# hysteresis applies per step, so a marginal recovery re-admits the low
# tier without flapping best-effort admission.
ESCALATE_STREAK = 3
# Minimum ack samples in a tick window before its p99 drives an AIMD
# knob move (a single straggler must not halve the knobs). The shed
# machine and the recovery contract use ANY-sample windows instead:
# their hard-breach evidence needs 2 consecutive windows anyway, and a
# lone post-heal probe ack is legitimate "back in SLO" evidence.
MIN_ADJUST_SAMPLES = 4
# Tick-summary ring depth (wire-encodable; chaos verdicts reconstruct
# the recovery timeline from it — deep enough to survive the post-heal
# drain phase between "recovered" and "collected").
TICK_RING = 512
TRANSITION_RING = 64


class SloController:
    """See module docstring. `dataplane_fn` returns the local DataPlane
    iff this broker currently drives the device program (knobs and
    engine-side shed signals exist only there); `degraded_fn` is the
    broker's quorum-degradation signal (engine replica quorum lost, or
    an armed replication plane with zero live standbys)."""

    def __init__(self, config, metrics, recorder,
                 dataplane_fn: Callable[[], Optional[object]],
                 degraded_fn: Optional[Callable[[], bool]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time) -> None:
        self.enabled = float(config.slo_p99_ack_ms) > 0
        self.target_ms = float(config.slo_p99_ack_ms)
        self.consume_target_ms = float(config.slo_p99_consume_ms)
        self.consume_enabled = self.consume_target_ms > 0
        self.tick_s = float(config.slo_tick_s)
        self.recover_s = float(config.slo_recover_s)
        self.rc_min = float(config.slo_read_coalesce_min_s)
        self.rc_max = float(config.slo_read_coalesce_max_s)
        self.cd_min = int(config.slo_chain_depth_min)
        self.cd_max = int(config.slo_chain_depth_max)
        self.sw_min = int(config.slo_settle_window_min)
        # A measured prior (bench.py operating_curve writes one) narrows
        # the static config rails so the AIMD law starts from this
        # deployment's observed knee instead of the shipped defaults.
        # Best-effort: a missing or malformed file keeps the config
        # rails — a stale prior must never stop a broker from booting.
        self._load_rails(str(getattr(config, "slo_rails_file", "") or ""))
        # Additive-increase step: 16 steps span the rail range, so a
        # recovered system re-earns its throughput posture over ~16
        # comfortable ticks instead of snapping back into the breach.
        self.rc_step = max(1e-4, (self.rc_max - self.rc_min) / 16.0)
        self.shed_occupancy = float(config.slo_shed_occupancy)
        self.admission = AdmissionController(
            dict(config.slo_quotas), clock=clock,
            tiers=dict(config.slo_tenant_tiers))
        # Elastic-partition trigger thresholds (broker duty loop reads
        # split_wanted()/merge_wanted(); the controller only ACCUMULATES
        # evidence — proposing a reconfiguration is the broker's job,
        # where the metadata propose path and the engine live).
        self.split_auto = bool(config.split_auto)
        self.split_evidence_ticks = int(config.split_evidence_ticks)
        self.split_merge_idle_ticks = int(config.split_merge_idle_ticks)
        self._metrics = metrics
        self._recorder = recorder
        self._dataplane_fn = dataplane_fn
        self._degraded_fn = degraded_fn or (lambda: False)
        self._clock = clock
        self._wall = wall_clock
        # The ack histogram OBJECT is resolved once; tick() reads its
        # bins racy-consistent (the accepted metrics contract). With
        # the registry disabled there are no bins and every window
        # reads as no-data (config validation keeps enabled+disabled
        # from ever combining).
        self._hist = metrics.histogram("produce.ack_us")
        self._prev_bins: Optional[list[int]] = None
        self._consume_hist = metrics.histogram("consume.ack_us")
        self._prev_consume_bins: Optional[list[int]] = None
        self._lock = make_lock("SloController._lock")
        # --- state under _lock ---
        self._shed = False
        self._shed_level = 0
        self._breach_streak = 0  # evidencing ticks while already shedding
        self._shed_count = 0
        self._adjusts = 0
        self._ticks = 0
        # Split/merge evidence runs: consecutive breach ticks arm a
        # split; consecutive comfortable-or-idle ticks arm the reverse
        # merge (hysteresis — split_merge_idle_ticks defaults deep).
        self._breach_run = 0
        self._calm_run = 0
        # Per-signal evidence rings: 1 per tick the signal evidenced,
        # trimmed to EVIDENCE_WINDOW (see the module constants).
        self._occ_ev: list[int] = []
        self._fail_ev: list[int] = []
        self._clear_streak = 0
        # Previous-tick snapshots of the plane's cumulative settle
        # counters (delta = events since last tick). A controller
        # failover swaps the plane and resets them to zero — max(0, …)
        # reads the swap as a quiet tick, not a negative burst.
        self._prev_step_errors = 0
        self._prev_backpressure = 0
        self._last_p99_ms: Optional[float] = None
        self._last_ok: Optional[bool] = None
        self._last_consume_p99_ms: Optional[float] = None
        self._last_consume_ok: Optional[bool] = None
        self._last_reasons: list[str] = []
        # [t, p99_ms (-1 = no data), ok (1/0, -1 = no data), shed]
        self._tick_ring: list[list[float]] = []
        # [t, 1.0 (on) / 0.0 (off)]
        self._transitions: list[list[float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="slo-controller",
        )

    # ------------------------------------------------------------ rails

    def _load_rails(self, path: str) -> None:
        """Narrow the config rails from a measured prior (JSON written by
        `python bench.py operating_curve`). Keys are optional; each one
        present replaces the matching rail, then the pairs are re-ordered
        so a prior measured under a different build can never produce an
        inverted rail. Any failure keeps the config rails."""
        if not path:
            return
        import json

        try:
            with open(path) as f:
                prior = json.load(f)
            rails = prior.get("rails", prior)
            if "read_coalesce_min_s" in rails:
                self.rc_min = float(rails["read_coalesce_min_s"])
            if "read_coalesce_max_s" in rails:
                self.rc_max = float(rails["read_coalesce_max_s"])
            if "chain_depth_min" in rails:
                self.cd_min = max(1, int(rails["chain_depth_min"]))
            if "chain_depth_max" in rails:
                self.cd_max = max(1, int(rails["chain_depth_max"]))
            if "settle_window_min" in rails:
                self.sw_min = max(1, int(rails["settle_window_min"]))
            if self.rc_min > self.rc_max:
                self.rc_min, self.rc_max = self.rc_max, self.rc_min
            if self.cd_min > self.cd_max:
                self.cd_min, self.cd_max = self.cd_max, self.cd_min
            log.info("slo rails loaded from %s: rc=[%g,%g] cd=[%d,%d] "
                     "sw_min=%d", path, self.rc_min, self.rc_max,
                     self.cd_min, self.cd_max, self.sw_min)
        except Exception as e:
            log.warning("slo_rails_file %s unusable (%s: %s) — keeping "
                        "config rails", path, type(e).__name__, e)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self.enabled or self.consume_enabled:
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.tick_s):
            try:
                self.tick()
            except Exception as e:  # the loop must outlive one bad tick
                log.warning("slo tick failed: %s: %s", type(e).__name__, e)

    # ------------------------------------------------------------ produce

    def admit(self, producer_name: Optional[str], n: int) -> Optional[str]:
        """The produce front door (server._handle_produce calls this
        before any other work). None = admitted."""
        return self.admission.admit(producer_name, n)

    # ------------------------------------------------------------ the loop

    @staticmethod
    def _delta_p99(cur: list[int],
                   prev: Optional[list[int]]) -> tuple[Optional[float], int]:
        """(p99 in ms, sample count) of the window between two cumulative
        log2-bin snapshots. (None, 0) with no data."""
        if prev is None:
            return None, 0
        delta = [max(0, c - p) for c, p in zip(cur, prev)]
        count = sum(delta)
        if count == 0:
            return None, 0
        target = 0.99 * count
        seen = 0
        for i, b in enumerate(delta):
            seen += b
            if seen >= target:
                return (1 << i) / 1000.0, count
        return (1 << (len(delta) - 1)) / 1000.0, count

    def _window_p99_ms(self) -> tuple[Optional[float], int]:
        """(p99 of this tick's produce-ack window in ms, sample count)
        from the cumulative histogram's bin delta. (None, 0) no data."""
        bins = getattr(self._hist, "bins", None)
        if bins is None:
            return None, 0
        cur = list(bins)
        prev = self._prev_bins
        self._prev_bins = cur
        return self._delta_p99(cur, prev)

    def _consume_window_p99_ms(self) -> tuple[Optional[float], int]:
        """The consume-side window p99 (the twin of _window_p99_ms)."""
        bins = getattr(self._consume_hist, "bins", None)
        if bins is None:
            return None, 0
        cur = list(bins)
        prev = self._prev_consume_bins
        self._prev_consume_bins = cur
        return self._delta_p99(cur, prev)

    def tick(self) -> dict:
        """One control decision. Returns the tick summary (tests drive
        this directly; the thread discards it)."""
        t = self._wall()
        dp = self._dataplane_fn()
        with self._lock:  # _prev_bins rides the controller's own mutex
            p99_ms, samples = self._window_p99_ms()
            c_p99_ms, c_samples = self._consume_window_p99_ms()
        ok: Optional[bool] = None
        if samples >= 1 and p99_ms is not None:
            ok = p99_ms <= self.target_ms
        c_ok: Optional[bool] = None
        if c_samples >= 1 and c_p99_ms is not None:
            c_ok = c_p99_ms <= self.consume_target_ms
        knobs = dp.knob_state() if dp is not None else None
        bp = se = None
        if knobs is not None:
            bp = int(getattr(dp, "settle_backpressure", 0))
            se = int(getattr(dp, "step_errors", 0))
        stall_hit = bool(dp is not None and dp.stalled_slots())
        degraded = bool(self._degraded_fn())

        turn_on_reasons: Optional[list[str]] = None
        turn_off = False
        with self._lock:
            occ_hit = fail_hit = False
            if knobs is not None:
                need = max(1, math.ceil(self.shed_occupancy
                                        * knobs["settle_window"]))
                # Sampled depth OR the integrated backpressure delta: a
                # sub-tick stall leaves its counter increments behind.
                occ_hit = (knobs["settle_inflight"] >= need
                           or bp > self._prev_backpressure)
                self._prev_backpressure = bp
                fail_hit = se > self._prev_step_errors
                self._prev_step_errors = se
            self._ticks += 1
            self._last_p99_ms = p99_ms
            self._last_ok = ok
            # Split/merge evidence: a measured breach tick extends the
            # split run; ANY other tick (meeting the target, or no data
            # at all — an idle partition is the merge candidate by
            # definition) extends the calm run and breaks the breach.
            if ok is False:
                self._breach_run += 1
                self._calm_run = 0
            else:
                self._breach_run = 0
                self._calm_run += 1
            self._last_consume_p99_ms = c_p99_ms
            self._last_consume_ok = c_ok
            for ring, hit in ((self._occ_ev, occ_hit),
                              (self._fail_ev, fail_hit)):
                ring.append(1 if hit else 0)
                del ring[:-EVIDENCE_WINDOW]
            reasons = []
            if degraded:
                reasons.append("quorum_degraded")
            if stall_hit:
                reasons.append("stall_streak")
            if sum(self._occ_ev) >= EVIDENCE_MIN:
                reasons.append("settle_occupancy")
            if sum(self._fail_ev) >= EVIDENCE_MIN:
                reasons.append("settle_failures")
            self._last_reasons = reasons
            level_before = self._shed_level
            if reasons:
                self._clear_streak = 0
                if not self._shed:
                    self._shed = True
                    self._shed_level = 1
                    self._breach_streak = 0
                    self._shed_count += 1
                    turn_on_reasons = reasons
                    self._transitions.append([t, 1.0])
                    del self._transitions[:-TRANSITION_RING]
                else:
                    # Ladder escalation: a shed that HOLDS through more
                    # evidencing ticks refuses the low tier too.
                    self._breach_streak += 1
                    if (self._shed_level == 1
                            and self._breach_streak >= ESCALATE_STREAK):
                        self._shed_level = 2
                        self._breach_streak = 0
            else:
                self._clear_streak += 1
                self._breach_streak = 0
                if self._shed and self._clear_streak >= CLEAR_STREAK:
                    # One ladder step per earned streak: level 2 first
                    # re-admits the low tier, THEN a fresh streak ends
                    # the shed entirely.
                    self._shed_level -= 1
                    self._clear_streak = 0
                    if self._shed_level <= 0:
                        self._shed = False
                        self._shed_level = 0
                        turn_off = True
                        self._transitions.append([t, 0.0])
                        del self._transitions[:-TRANSITION_RING]
            level_now = self._shed_level
            shed_now = self._shed
            self._tick_ring.append([
                t,
                -1.0 if p99_ms is None else float(p99_ms),
                -1.0 if ok is None else (1.0 if ok else 0.0),
                1.0 if shed_now else 0.0,
            ])
            del self._tick_ring[:-TICK_RING]
        # Transitions act OUTSIDE the controller lock (admission has
        # its own mutex; the recorder is lock-free).
        if level_now != level_before:
            self.admission.set_shed_level(level_now)
        if turn_on_reasons is not None:
            self._recorder.record(
                "slo_shed_on", reason=",".join(turn_on_reasons),
                level=level_now,
                p99_ms=-1.0 if p99_ms is None else round(p99_ms, 3),
            )
            log.warning("slo: load shedding ON (%s; p99=%s ms)",
                        ",".join(turn_on_reasons), p99_ms)
        elif turn_off:
            self._recorder.record(
                "slo_shed_off",
                p99_ms=-1.0 if p99_ms is None else round(p99_ms, 3),
            )
            log.info("slo: load shedding OFF (p99=%s ms)", p99_ms)
        elif level_now != level_before:
            # Intermediate ladder move (1→2 escalation, 2→1 step-down):
            # the shed stays on, only its tier bite changed.
            self._recorder.record(
                "slo_shed_level", level=level_now,
                reason=",".join(reasons) if reasons else "clear_streak",
                p99_ms=-1.0 if p99_ms is None else round(p99_ms, 3),
            )
            log.warning("slo: shed level %d -> %d (%s)",
                        level_before, level_now,
                        ",".join(reasons) or "clear_streak")

        applied = None
        if dp is not None and knobs is not None and ok is not None \
                and samples >= MIN_ADJUST_SAMPLES and self.enabled:
            applied = self._adjust(dp, knobs, ok, p99_ms, shed_now)
        c_applied = None
        if dp is not None and knobs is not None and c_ok is not None \
                and c_samples >= MIN_ADJUST_SAMPLES and self.consume_enabled:
            # Runs after the produce law on purpose: it reads the
            # POST-adjust knob state, so the shared read_coalesce_s
            # never takes two conflicting moves in one tick.
            c_applied = self._adjust_consume(
                dp, c_ok, c_p99_ms, shed_now,
                produce_breach=(self.enabled and ok is False))
        return {"t": t, "p99_ms": p99_ms, "samples": samples, "ok": ok,
                "consume_p99_ms": c_p99_ms, "consume_samples": c_samples,
                "consume_ok": c_ok,
                "shed": shed_now, "reasons": reasons,
                "knobs": c_applied if applied is None else applied}

    def _adjust(self, dp, knobs: dict, ok: bool, p99_ms: float,
                shed: bool) -> Optional[dict]:
        """The AIMD law (controller broker only). Returns the applied
        knob state when anything changed, else None."""
        rc = float(knobs["read_coalesce_s"])
        cd = int(knobs["chain_depth"])
        sw = int(knobs["settle_window"])
        sw_cap = int(knobs["settle_window_cap"])
        if not ok:
            # Multiplicative decrease: shed latency posture fast.
            nrc = max(self.rc_min, rc * 0.5)
            ncd = max(self.cd_min, cd // 2)
            nsw = max(self.sw_min, sw // 2)
        elif p99_ms <= 0.5 * self.target_ms:
            # Additive increase (chain rides its power-of-two compile
            # ladder) only with real margin — meeting the target
            # exactly is equilibrium, not headroom.
            nrc = min(self.rc_max, rc + self.rc_step)
            ncd = min(self.cd_max, cd * 2)
            nsw = min(sw_cap, sw + 1)
        else:
            return None
        if (abs(nrc - rc) < 1e-9) and ncd == cd and nsw == sw:
            return None
        applied = dp.set_knobs(read_coalesce_s=nrc, chain_depth=ncd,
                               settle_window=nsw)
        with self._lock:
            self._adjusts += 1
        self._recorder.record(
            "slo_adjust", loop="produce",
            p99_ms=round(p99_ms, 3), ok=bool(ok), shed=bool(shed),
            read_coalesce_us=int(applied["read_coalesce_s"] * 1e6),
            chain_depth=int(applied["chain_depth"]),
            settle_window=int(applied["settle_window"]),
        )
        return applied

    def _adjust_consume(self, dp, ok: bool, p99_ms: float, shed: bool,
                        produce_breach: bool) -> Optional[dict]:
        """The consume twin's AIMD law: read_coalesce_s only (the one
        knob on the consume ack path — chain depth and the settle window
        shape the PRODUCE pipe). Reads fresh knob state so a same-tick
        produce adjustment is already visible."""
        knobs = dp.knob_state()
        rc = float(knobs["read_coalesce_s"])
        if not ok:
            nrc = max(self.rc_min, rc * 0.5)
        elif p99_ms <= 0.5 * self.consume_target_ms and not produce_breach:
            # Walk back toward throughput only when the produce loop is
            # not mid-breach: the knob is shared, and re-raising it the
            # same tick the produce law halved it would oscillate.
            nrc = min(self.rc_max, rc + self.rc_step)
        else:
            return None
        if abs(nrc - rc) < 1e-9:
            return None
        applied = dp.set_knobs(read_coalesce_s=nrc)
        with self._lock:
            self._adjusts += 1
        self._recorder.record(
            "slo_adjust", loop="consume",
            p99_ms=round(p99_ms, 3), ok=bool(ok), shed=bool(shed),
            read_coalesce_us=int(applied["read_coalesce_s"] * 1e6),
            chain_depth=int(applied["chain_depth"]),
            settle_window=int(applied["settle_window"]),
        )
        return applied

    # ----------------------------------------------- elastic-partition arm

    def split_wanted(self) -> bool:
        """True when `split_auto` is on and the produce SLO has breached
        for `split_evidence_ticks` CONSECUTIVE measured ticks — the
        broker's reconfig duty then proposes a split of the hottest
        partition and calls note_reconfig()."""
        with self._lock:
            return (self.split_auto
                    and self._breach_run >= self.split_evidence_ticks)

    def merge_wanted(self) -> bool:
        """True when `split_auto` is on and the cluster has been
        comfortable or idle for `split_merge_idle_ticks` consecutive
        ticks — deep hysteresis, so a load lull between bursts does not
        merge what the next burst would immediately re-split."""
        with self._lock:
            return (self.split_auto
                    and self._calm_run >= self.split_merge_idle_ticks)

    def note_reconfig(self) -> None:
        """A split/merge was just proposed off this controller's
        evidence: restart both runs so one sustained breach arms exactly
        one reconfiguration, not one per duty pass."""
        with self._lock:
            self._breach_run = 0
            self._calm_run = 0

    # ------------------------------------------------------------ surface

    def stats(self) -> dict:
        """The admin.stats `slo` block: mode, current knob values, shed
        counts, and the tick/transition history chaos verdicts replay
        (wire-encodable)."""
        dp = self._dataplane_fn()
        knobs = dp.knob_state() if dp is not None else None
        with self._lock:
            return {
                "enabled": self.enabled,
                "mode": ("off" if not (self.enabled or self.consume_enabled)
                         else "shed" if self._shed else "steady"),
                "target_p99_ms": self.target_ms,
                "p99_ms": self._last_p99_ms,
                "meeting_slo": self._last_ok,
                "consume_enabled": self.consume_enabled,
                "target_p99_consume_ms": self.consume_target_ms,
                "consume_p99_ms": self._last_consume_p99_ms,
                "consume_meeting_slo": self._last_consume_ok,
                "ticks": self._ticks,
                "adjustments": self._adjusts,
                "shed_count": self._shed_count,
                "shed_level": self._shed_level,
                "shed_reasons": list(self._last_reasons),
                "split_auto": self.split_auto,
                "breach_run": self._breach_run,
                "calm_run": self._calm_run,
                "admission": self.admission.stats(),
                "knobs": knobs,
                "transitions": [list(x) for x in self._transitions],
                "tick_history": [list(x) for x in self._tick_ring],
            }
