"""The engine slice as a whole: the port's `make_local_fns` against the
reference's, round by round.

One seeded scenario is replayed through both engines under all four flag
sets (legacy, fused, packed, fused+packed). It starts from ONE state:
the reference runs a few rounds, and `convert.state_from_numpy` carries
its state into the port. Then every one of the eleven entry points runs
on both — dense and sparse rounds, chained and single, quorum failures,
dead leaders, per-partition alive masks, offset commits, a ring that
wraps behind a host-advanced trim, an election, a resync of a lagging
replica, reads of every kind, and `init_from` — and after EVERY call
every state leaf and every output must be equal. All values are
integers: the tolerance is exact equality (packed mode included: both
engines apply the same extent-class rule, so even the bytes past a
round's extent agree).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ripplemq_tpu.core import encode as ref_encode
from ripplemq_tpu.core import state as ref_state
from ripplemq_tpu.core.config import EngineConfig as RefConfig
from ripplemq_tpu.parallel.engine import make_local_fns as ref_make_local_fns
from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.core import encode as port_encode
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.parallel.engine import make_local_fns
from tests.torch_port_modules import admit

admit(__name__)

# (flags, B, SB, S): every flag set, both batch widths, both row widths.
VARIANTS = {
    "legacy": (dict(), 8, 32, 128),
    "fused": (dict(fused_control=True), 16, 128, 128),
    "packed": (dict(packed_writes=True), 16, 32, 128),
    "fused+packed": (dict(fused_control=True, packed_writes=True), 8, 128, 128),
}
P, R, K, A = 16, 3, 3, 8
ALL = np.ones(R, bool)


def _cfgs(variant):
    flags, B, SB, S = VARIANTS[variant]
    shape = dict(partitions=P, replicas=R, slots=S, slot_bytes=SB,
                 max_batch=B, read_batch=12, max_consumers=8,
                 max_offset_updates=4, **flags)
    return EngineConfig(**shape), RefConfig(**shape)


class Pair:
    """Both engines, driven in lockstep and compared after every call."""

    def __init__(self, variant):
        self.cfg, self.rcfg = _cfgs(variant)
        self.ref = ref_make_local_fns(self.rcfg)
        self.port = make_local_fns(self.cfg, device="cpu")
        self.calls = set()

    def ref_snapshot(self):
        return {k: np.asarray(v) for k, v in self.rstate._asdict().items()}

    def check_state(self, what):
        want = self.ref_snapshot()
        got = convert.state_to_numpy(self.pstate)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{what}: state.{name}")

    @staticmethod
    def check_out(what, got, want):
        def flat(x):
            return [y for e in x for y in flat(e)] if isinstance(x, tuple) else [x]

        got, want = flat(got), flat(want)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert isinstance(g, torch.Tensor), f"{what}[{i}] is not a tensor"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{what}: output {i}")

    def mutate(self, name, *args, n_out=1, **kw):
        """A call that advances the state: (state, *outs) on both sides."""
        self.calls.add(name)
        r = getattr(self.ref, name)(self.rstate, *args, **kw)
        p = getattr(self.port, name)(self.pstate, *args, **kw)
        if n_out == 0:
            self.rstate, self.pstate = r, p
        else:
            self.rstate, self.pstate = r[0], p[0]
            self.check_out(name, tuple(p[1:]), tuple(r[1:]))
        self.check_state(name)
        return r

    def query(self, name, *args):
        self.calls.add(name)
        self.check_out(name, getattr(self.port, name)(self.pstate, *args),
                       getattr(self.ref, name)(self.rstate, *args))


def _round(rng, cfg, leader, term, *, append_p=0.5, offsets_p=0.3):
    """One round's python values, encoded by BOTH encoders (which must
    agree), returned as the reference's StepInput of numpy arrays."""
    appends, ups = {}, {}
    for p in range(cfg.partitions):
        if rng.random() < append_p:
            n = int(rng.integers(1, cfg.max_batch + 1))
            appends[p] = [rng.integers(0, 256, int(rng.integers(
                1, cfg.payload_bytes + 1)), dtype=np.uint8).tobytes()
                for _ in range(n)]
        if rng.random() < offsets_p:
            k = int(rng.integers(1, cfg.max_offset_updates + 1))
            ups[p] = [(int(rng.integers(0, cfg.max_consumers)),
                       int(rng.integers(0, 500))) for _ in range(k)]
    want = ref_encode.build_step_input(cfg, appends, ups, leader, term)
    got = port_encode.build_step_input(cfg, appends, ups, leader, term)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    return want


def _stack(inputs):
    return ref_state.StepInput(*(np.stack(f) for f in zip(*inputs)))


def _compact(inp, rng):
    """Active-set form of a dense round: entries_c [A, B, SB] and slot_ids
    [A] (-1 pads, shuffled); up to A partitions with appends."""
    active = np.flatnonzero(inp.counts > 0)[:A]
    ids = np.full((A,), -1, np.int32)
    where = rng.permutation(A)[:len(active)]
    ids[where] = active
    ec = np.zeros((A,) + inp.entries.shape[1:], np.uint8)
    ec[where] = inp.entries[active]
    counts = np.where(np.isin(np.arange(len(inp.counts)), active),
                      inp.counts, 0).astype(np.int32)
    return inp._replace(counts=counts,
                        extents=ref_encode.row_extents(counts)), ec, ids


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_replay_matches_reference(variant):
    rng = np.random.default_rng(sorted(VARIANTS).index(variant))
    pair = Pair(variant)
    cfg = pair.cfg
    lead = {p: p % R for p in range(P)}

    # One starting state: the reference warms up, the port takes it over.
    pair.rstate = pair.ref.init()
    for _ in range(2):
        pair.rstate, _ = pair.ref.step(pair.rstate, _round(rng, cfg, lead, 1),
                                       ALL)
    pair.pstate = convert.state_from_numpy(cfg, pair.ref_snapshot(), "cpu")
    pair.check_state("state_from_numpy")
    assert torch.equal(pair.port.init().log_data,
                       torch.zeros_like(pair.pstate.log_data))

    def trim():
        return np.asarray(pair.rstate.commit).min(axis=0).astype(np.int32)

    # Dense rounds: commits, a minority (fails), a dead leader, a random
    # per-partition mask with per-partition quorums, a garbage round.
    pair.mutate("step", _round(rng, cfg, lead, 1), ALL)
    pair.mutate("step", _round(rng, cfg, lead, 1), np.array([1, 0, 0], bool))
    pair.mutate("step", _round(rng, cfg, lead, 1), np.array([0, 1, 1], bool))
    pair.mutate("step", _round(rng, cfg, lead, 1), rng.random((P, R)) < 0.8,
                quorum=rng.integers(1, R + 1, size=P).astype(np.int32))
    garbage = _round(rng, cfg, lead, 1)._replace(
        counts=rng.integers(-3, cfg.max_batch + 9, size=P).astype(np.int32),
        leader=rng.integers(-2, R + 2, size=P).astype(np.int32))
    pair.mutate("step", garbage, ALL)
    # Replica 2 misses rounds, then is resynced from replica 0.
    pair.mutate("step", _round(rng, cfg, lead, 1), np.array([1, 1, 0], bool))
    pair.mutate("step_many", _stack([_round(rng, cfg, lead, 1)
                                     for _ in range(K)]),
                np.array([1, 1, 0], bool), trim=trim())
    pair.mutate("resync", 0, 2, rng.random(P) < 0.7, n_out=0)
    pair.mutate("resync", 1, 2, np.ones(P, bool), n_out=0)

    # Sparse rounds until the ring has wrapped behind the trim.
    for i in range(12):
        inp, ec, ids = _compact(_round(rng, cfg, lead, 1, append_p=0.8), rng)
        if i % 3 == 2:
            chain = [_compact(_round(rng, cfg, lead, 1, append_p=0.8), rng)
                     for _ in range(K)]
            pair.mutate("step_many_sparse", _stack([c[0] for c in chain]),
                        np.stack([c[1] for c in chain]),
                        np.stack([c[2] for c in chain]), ALL, trim=trim())
        else:
            pair.mutate("step_sparse", inp, ec, ids, ALL, trim=trim())
    assert int(np.asarray(pair.rstate.commit).max()) > cfg.slots

    # An election: replica 1 takes a term-2 ballot on half the partitions
    # (plus out-of-range candidates), then leads the next rounds.
    cand = np.where(np.arange(P) % 2 == 0, 1,
                    rng.choice([-1, R], size=P)).astype(np.int32)
    pair.mutate("vote", cand, np.full(P, 2, np.int32), ALL, n_out=2)
    lead2 = {p: (1 if p % 2 == 0 else p % R) for p in range(P)}
    inp, ec, ids = _compact(_round(rng, cfg, lead2, 2, append_p=0.9), rng)
    pair.mutate("step_sparse", inp, ec, ids, ALL, trim=trim())

    # Reads of every kind, in range and out of it.
    S = cfg.slots
    commit = np.asarray(pair.rstate.commit)
    for r, p, off in ((0, 3, 0), (1, 5, int(commit[1, 5]) - 5),
                      (2, 0, int(commit[2, 0]) - cfg.read_batch - 3),
                      (-1, P + 2, -7), (R + 1, 4, 10 * S)):
        pair.query("read", np.int32(r), np.int32(p), np.int32(off))
    reps = rng.integers(-1, R + 1, size=24).astype(np.int32)
    parts = rng.integers(-1, P + 1, size=24).astype(np.int32)
    offs = (commit[reps.clip(0, R - 1), parts.clip(0, P - 1)]
            - rng.integers(-4, 2 * cfg.read_batch, size=24)).astype(np.int32)
    pair.query("read_many", reps, parts, offs)
    for r, p, c in ((0, 0, 0), (2, 7, 3), (-1, P, 99), (R, -1, -1)):
        pair.query("read_offset", np.int32(r), np.int32(p), np.int32(c))

    # init_from: a single-replica image installed on every replica.
    image = ref_state.ReplicaState(**{
        name: np.asarray(getattr(pair.rstate, name))[0]
        for name in ref_state.ReplicaState._fields})
    pair.rstate = pair.ref.init_from(image)
    pair.pstate = pair.port.init_from(image)
    pair.calls.add("init_from")
    pair.check_state("init_from")
    pair.mutate("step", _round(rng, cfg, lead2, 2), ALL)

    assert pair.calls | {"init"} == set(pair.port._fields)


def test_outputs_are_fresh_not_views_of_state():
    """A round's outputs stay as they were after later rounds ran."""
    cfg, _ = _cfgs("fused+packed")
    fns = make_local_fns(cfg, device="cpu")
    rng = np.random.default_rng(0)
    state = fns.init()
    lead = {p: 0 for p in range(P)}
    state, out = fns.step(state, _round(rng, cfg, lead, 1, append_p=1.0), ALL)
    before = [x.clone() for x in out]
    for _ in range(3):
        state, _ = fns.step(state, _round(rng, cfg, lead, 1, append_p=1.0), ALL)
    for x, y in zip(out, before):
        assert torch.equal(x, y)
    for leaf in state:
        for x in out:
            assert x.untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()


@pytest.mark.parametrize("fused", [False, True], ids=["named", "fused"])
def test_convert_accepts_either_layout(fused):
    """state_from_numpy takes the reference's state in either layout and
    returns the layout the port's config asks for."""
    cfg, rcfg = _cfgs("legacy")
    rng = np.random.default_rng(1)
    named = ref_state.ReplicaState(
        log_data=rng.integers(0, 256, (R, P, cfg.slots + cfg.max_batch,
                                       cfg.slot_bytes), dtype=np.uint8),
        **{f: rng.integers(0, 99, (R, P)).astype(np.int32)
           for f in ("log_end", "last_term", "current_term", "commit")},
        offsets=rng.integers(0, 99, (R, P, cfg.max_consumers)).astype(np.int32))
    src = ref_state.fuse_state(named) if fused else named
    src = {k: np.asarray(v) for k, v in src._asdict().items()}
    for want_fused in (False, True):
        pcfg = dataclasses.replace(cfg, fused_control=want_fused)
        got = convert.state_to_numpy(convert.state_from_numpy(pcfg, src, "cpu"))
        want = ref_state.fuse_state(named) if want_fused else named
        assert got.keys() == set(want._fields)
        for name in want._fields:
            np.testing.assert_array_equal(got[name],
                                          np.asarray(getattr(want, name)))
    inp = convert.input_from_numpy(_round(rng, cfg, 0, 1), "cpu")
    assert inp.entries.dtype == torch.uint8 and inp.counts.dtype == torch.int32
    assert convert.input_from_numpy(
        {**_round(rng, cfg, 0, 1)._asdict(), "extents": None}, "cpu").extents is None


def test_encoders_match_reference():
    """The host encoder the engine boundary takes its rounds from."""
    cfg, rcfg = _cfgs("legacy")
    rng = np.random.default_rng(2)
    uniform = [rng.integers(0, 256, 9, dtype=np.uint8).tobytes() for _ in range(5)]
    mixed = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(1, cfg.payload_bytes + 1, size=6)]
    for payloads in (uniform, mixed, []):
        got = port_encode.pack_payload_rows(cfg, payloads)
        want = ref_encode.pack_payload_rows(rcfg, payloads)
        np.testing.assert_array_equal(got, want)
        port_encode.stamp_term(got, 7)
        ref_encode.stamp_term(want, 7)
        np.testing.assert_array_equal(got, want)
    rows = port_encode.pack_rows(cfg, mixed, 3)
    np.testing.assert_array_equal(rows, ref_encode.pack_rows(rcfg, mixed, 3))
    lens = rows[:, 0:4].copy().view("<i4")[:, 0]
    for count in (0, 4, len(rows)):
        assert port_encode.decode_entries_with_pos(
            torch.from_numpy(rows), torch.from_numpy(lens), torch.tensor(count)
        ) == ref_encode.decode_entries_with_pos(rows, lens, count)
    np.testing.assert_array_equal(
        port_encode.row_extents(np.arange(-2, 20)),
        ref_encode.row_extents(np.arange(-2, 20)))
    for bad, err in (([b"x"] * (cfg.max_batch + 1), ValueError), ([b""], ValueError),
                     ([b"y" * (cfg.payload_bytes + 1)], ValueError), (["s"], TypeError)):
        with pytest.raises(err):
            port_encode.pack_rows(cfg, bad, 1)
        with pytest.raises(err):
            ref_encode.pack_rows(rcfg, bad, 1)
