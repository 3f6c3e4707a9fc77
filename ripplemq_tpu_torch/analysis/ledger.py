"""The suppression ledger: every shipped finding carries its WHY.

A waiver is (rule, finding-key, reason). Keys are stable
(`path::scope::symbol`) so waivers survive unrelated edits; a waiver
that stops matching becomes a `stale_waivers` entry in the verdict and
fails lint — dead suppressions silently shrink coverage, exactly like
a stale FAST_MODULES entry.

Discipline: a waiver is for a finding that is CORRECT but deliberate
(an impurity that is load-bearing, a reach-in that is the documented
exception). A finding that is merely annoying gets fixed, not waived.
"""

from ripplemq_tpu_torch.analysis.framework import Waiver

WAIVERS: tuple[Waiver, ...] = (
    # -- determinism ------------------------------------------------------
    Waiver(
        rule="determinism",
        key="ripplemq_tpu_torch/stripes/plane.py::__init__::time.time",
        reason=(
            "The gsn SEED is wall-clock ON PURPOSE: a 0-based counter "
            "collided across controller restarts within one epoch and "
            "the striped soak read the overlap as mixed generations "
            "(found+fixed by the seed-2 soak). Uniqueness across "
            "process lifetimes is the requirement; determinism would "
            "reintroduce the collision. Everything DERIVED from the "
            "seed stays pure."
        ),
    ),
    # -- lock_discipline --------------------------------------------------
    Waiver(
        rule="lock_discipline",
        key="ripplemq_tpu_torch/storage/segment.py::flush::fsync",
        reason=(
            "flush() is the SYNCHRONOUS durability barrier (boot "
            "replay, promotion, stop, strict mode): holding _lock over "
            "the fsync is what orders the barrier after every append "
            "that returned before it. The hot path never calls this — "
            "it rides flush_async()'s independent-fd flusher thread "
            "exactly so no appender waits on an fsync."
        ),
    ),
    Waiver(
        rule="lock_discipline",
        key="ripplemq_tpu_torch/storage/segment.py::gc::fsync",
        reason=(
            "gc() fsyncs the gc_floor marker under _lock so the floor "
            "file can never name a segment a concurrent append path "
            "still considers live. GC runs at segment-rotation cadence "
            "(one fsync per ~64 MB sealed), not on the message path."
        ),
    ),
    # -- ownership --------------------------------------------------------
    Waiver(
        rule="ownership",
        key="ripplemq_tpu_torch/broker/server.py::BrokerServer::_promoted_live",
        reason=(
            "Monotone latch (False -> True, never cleared): the raft "
            "apply thread sets it on a witnessed live promotion, the "
            "duty thread sets it when adopting a recovered claim with "
            "no standby to abdicate to. Both writers store the same "
            "value; a racing read that misses the latch costs at most "
            "one extra abdication check next duty tick, never an "
            "incorrect boot (the duty re-reads every pass)."
        ),
    ),
    Waiver(
        rule="ownership",
        key="ripplemq_tpu_torch/broker/dataplane.py::DataPlane::_host_ring",
        reason=(
            "Deliberate single-writer design: _mirror_records is the "
            "settle thread's private fast path (one memcpy per settled "
            "round — putting it under the contended control lock would "
            "serialize the mirror against every submit), and install() "
            "only runs on a freshly constructed plane BEFORE start() "
            "(server._boot_dataplane: install precedes dp.start(), so "
            "no settle thread exists yet). The two writers are "
            "separated by the thread-start happens-before edge, not a "
            "mutex — which the AST cannot see."
        ),
    ),
    Waiver(
        rule="lock_discipline",
        key="ripplemq_tpu_torch/storage/segment.py::close::fsync",
        reason=(
            "close() is shutdown: the final fsync under _lock is the "
            "store's last durability barrier and nothing contends the "
            "lock after stop."
        ),
    ),
    # -- lock_discipline: the card's verification script ------------------
    Waiver(
        rule="lock_discipline",
        key="chip_smoke.py::check_device_ring::_state",
        reason=(
            "The verification script reads a quiesced plane: every "
            "acked produce has returned and no round is queued when "
            "check_device_ring runs, and the read of the device log "
            "sits inside `with dp._device_lock:` (the plane's own "
            "lock, which the AST cannot tie to the plane). It is a "
            "white-box check of the rows the append kernel wrote — "
            "the thing no public accessor exposes, by design."
        ),
    ),
    Waiver(
        rule="lock_discipline",
        key="chip_smoke.py::check_device_ring::_host_ring",
        reason=(
            "The verification script reads a quiesced plane: the "
            "settle thread (the mirror's single runtime writer) has "
            "released every acked round before check_device_ring "
            "runs, and nothing is submitted while it compares the "
            "host mirror's rows with the acked messages. A white-box "
            "check, not a host-path reader."
        ),
    ),
)
