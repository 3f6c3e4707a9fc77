"""Unit tests for the pure replication steps (local mode, 1 device).

These are the deterministic-Raft tests the reference never had
(SURVEY.md §4: "deterministic Raft step functions testable as pure
code").

Twin of `tests/test_core_step.py` on the PyTorch port: each scenario
runs through `TwinFns`, which drives the port's `make_local_fns(cfg,
device="cpu")` and the reference's engine in lockstep on the same
inputs and holds every output and every state leaf equal after every
call (exact: all integers), while the test's own assertions read the
port's values.
"""

import numpy as np
import pytest

from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.core.encode import decode_entries as decode_read
from tests.torch_helpers import TwinFns, make_input, port_cfg
from tests.torch_helpers import read_committed as read_all
from tests.torch_port_modules import admit

admit(__name__)

ALL_ALIVE = np.array([True, True, True])


@pytest.fixture(scope="module")
def cfg():
    return port_cfg()


@pytest.fixture(scope="module")
def fns(cfg):
    return TwinFns(cfg)


def test_append_commits_with_full_quorum(cfg, fns):
    state = fns.init()
    msgs = [b"hello", b"world", b"tpu-queue"]
    inp = make_input(cfg, appends={0: msgs})
    state, out = fns.step(state, inp, ALL_ALIVE)

    assert int(out.votes[0]) == 3
    assert bool(out.committed[0])
    assert int(out.commit[0]) == 8  # 3 rows padded to the ALIGN boundary
    assert int(out.base[0]) == 0
    # untouched partition
    assert int(out.commit[1]) == 0

    data, lens, count = fns.read(state, 0, 0, 0)
    assert decode_read(data, lens, count) == msgs


def test_appends_accumulate_across_rounds(cfg, fns):
    state = fns.init()
    state, out1 = fns.step(state, make_input(cfg, appends={1: [b"a", b"b"]}), ALL_ALIVE)
    state, out2 = fns.step(state, make_input(cfg, appends={1: [b"c"]}), ALL_ALIVE)
    assert int(out2.base[1]) == 8   # round 2 starts at the next ALIGN block
    assert int(out2.commit[1]) == 16
    assert read_all(fns, state, 0, 1, start=1) == [b"b", b"c"]


def test_majority_commits_minority_does_not(cfg, fns):
    state = fns.init()
    # 2/3 alive: commits
    state, out = fns.step(
        state, make_input(cfg, appends={0: [b"x"]}), np.array([True, True, False])
    )
    assert int(out.votes[0]) == 2 and bool(out.committed[0])
    # 1/3 alive: leader appends locally but nothing commits
    state, out = fns.step(
        state, make_input(cfg, appends={0: [b"y"]}), np.array([True, False, False])
    )
    assert int(out.votes[0]) == 1
    assert not bool(out.committed[0])
    assert int(out.commit[0]) == 8  # unchanged


def test_lagging_follower_rejects_then_resyncs(cfg, fns):
    state = fns.init()
    # replica 2 dead while two entries commit
    state, _ = fns.step(
        state, make_input(cfg, appends={0: [b"m1", b"m2"]}), np.array([True, True, False])
    )
    # replica 2 back, but its log is behind -> it cannot ack (log-matching)
    state, out = fns.step(state, make_input(cfg, appends={0: [b"m3"]}), ALL_ALIVE)
    assert int(out.votes[0]) == 2  # only replicas 0,1 ack
    assert bool(out.committed[0])
    # host-driven resync: copy leader rows onto replica 2
    mask = np.array([True, False, False, False])
    state = fns.resync(state, np.int32(0), np.int32(2), mask)
    state, out = fns.step(state, make_input(cfg, appends={0: [b"m4"]}), ALL_ALIVE)
    assert int(out.votes[0]) == 3
    assert int(out.commit[0]) == 24  # three ALIGN-padded rounds
    assert read_all(fns, state, 2, 0) == [b"m1", b"m2", b"m3", b"m4"]


def test_no_leader_no_progress(cfg, fns):
    state = fns.init()
    inp = make_input(cfg, appends={0: [b"z"]}, leader={})  # leader=-1 everywhere
    state, out = fns.step(state, inp, ALL_ALIVE)
    assert int(out.votes[0]) == 0
    assert int(out.commit[0]) == 0


def test_dead_leader_no_progress(cfg, fns):
    state = fns.init()
    inp = make_input(cfg, appends={0: [b"z"]}, leader=1)
    state, out = fns.step(state, inp, np.array([True, False, True]))
    assert int(out.votes[0]) == 0
    assert int(out.commit[0]) == 0


def test_offset_update_rides_quorum(cfg, fns):
    state = fns.init()
    inp = make_input(cfg, appends={2: [b"m"]}, offset_updates={2: [(3, 17)]})
    state, out = fns.step(state, inp, ALL_ALIVE)
    assert int(fns.read_offset(state, 0, 2, 3)) == 17
    assert int(fns.read_offset(state, 1, 2, 3)) == 17  # replicated
    # minority round: offset update must NOT apply
    inp = make_input(cfg, appends={2: [b"n"]}, offset_updates={2: [(3, 99)]})
    state, out = fns.step(state, inp, np.array([True, False, False]))
    assert int(fns.read_offset(state, 0, 2, 3)) == 17


def test_offset_only_round_commits(cfg, fns):
    # an offset commit with no data batch must still replicate (consumers
    # commit on idle partitions; the reference routes these through the
    # same partition Raft log regardless of appends)
    state = fns.init()
    inp = make_input(cfg, offset_updates={0: [(1, 5)]})
    state, out = fns.step(state, inp, ALL_ALIVE)
    assert int(out.votes[0]) == 3
    assert bool(out.committed[0])
    assert int(fns.read_offset(state, 0, 0, 1)) == 5
    assert int(fns.read_offset(state, 2, 0, 1)) == 5
    # but log_end must not move
    assert int(state.log_end[0, 0]) == 0


def test_capacity_backpressure(cfg, fns):
    state = fns.init()
    per_round = cfg.max_batch
    rounds = cfg.slots // per_round
    payload = [bytes([65 + i % 26]) for i in range(per_round)]
    for _ in range(rounds):
        state, out = fns.step(state, make_input(cfg, appends={0: payload}), ALL_ALIVE)
    assert int(out.commit[0]) == cfg.slots
    # full: next round must not ack or advance
    state, out = fns.step(state, make_input(cfg, appends={0: [b"q"]}), ALL_ALIVE)
    assert int(out.votes[0]) == 0
    assert int(out.commit[0]) == cfg.slots


def test_partial_batch_near_capacity(cfg, fns):
    # The write phase lands a full max_batch window, so the last round in
    # a partition needs base + max_batch <= slots; a partial batch there
    # still commits (padded to the boundary), after which the partition
    # backpressures.
    state = fns.init()
    per_round = cfg.max_batch
    payload = [b"f"] * per_round
    for _ in range(cfg.slots // per_round - 1):
        state, _ = fns.step(state, make_input(cfg, appends={0: payload}), ALL_ALIVE)
    # log_end = slots - max_batch; a partial batch pads to the boundary
    state, out = fns.step(
        state, make_input(cfg, appends={0: payload[: per_round - 3]}), ALL_ALIVE
    )
    assert bool(out.committed[0])
    assert int(out.commit[0]) == cfg.slots
    # and one more must backpressure
    state, out = fns.step(state, make_input(cfg, appends={0: [b"y"]}), ALL_ALIVE)
    assert int(out.votes[0]) == 0


def test_read_window_near_log_tail(cfg, fns):
    # offset within read_batch of the tail: returned entries must be the
    # ones AT the offset, not a clamped window silently relabeled
    state = fns.init()
    msgs = [bytes([48 + i]) for i in range(10)]  # b"0".."9"
    state, _ = fns.step(state, make_input(cfg, appends={0: msgs[:8]}), ALL_ALIVE)
    state, _ = fns.step(state, make_input(cfg, appends={0: msgs[8:]}), ALL_ALIVE)
    # fill partition to capacity so commit == slots
    while True:
        remaining = cfg.slots - int(state.log_end[0, 0])
        if remaining <= 0:
            break
        fill = [b"z"] * min(cfg.max_batch, remaining)
        state, _ = fns.step(state, make_input(cfg, appends={0: fill}), ALL_ALIVE)
    # read at slots-3: must be the last 3 fill entries, not an earlier window
    data, lens, count = fns.read(state, 0, 0, cfg.slots - 3)
    assert decode_read(data, lens, count) == [b"z", b"z", b"z"]
    assert int(count) == 3
    # and a mid-log read still lines up with absolute offsets
    data, lens, count = fns.read(state, 0, 0, 6)
    assert decode_read(data, lens, count)[:4] == [b"6", b"7", b"8", b"9"]


def test_determinism_same_input_same_state(cfg, fns):
    def run():
        state = fns.init()
        state, _ = fns.step(
            state, make_input(cfg, appends={0: [b"a"], 3: [b"b", b"c"]}), ALL_ALIVE
        )
        state, _ = fns.step(
            state,
            make_input(cfg, appends={1: [b"d"]}, offset_updates={0: [(0, 1)]}),
            np.array([True, True, False]),
        )
        return state

    s1, s2 = run(), run()
    a, b = convert.state_to_numpy(s1.port), convert.state_to_numpy(s2.port)
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_read_only_exposes_committed(cfg, fns):
    state = fns.init()
    # minority append: leader has the entry but it is NOT committed
    state, _ = fns.step(
        state, make_input(cfg, appends={0: [b"u"]}), np.array([True, False, False])
    )
    data, lens, count = fns.read(state, 0, 0, 0)
    assert int(count) == 0


class TestVote:
    def test_fresh_candidate_wins(self, cfg, fns):
        state = fns.init()
        cand = np.full((cfg.partitions,), -1, np.int32)
        cand[0] = 1
        cand_term = np.full((cfg.partitions,), 1, np.int32)
        state, elected, votes = fns.vote(state, cand, cand_term, ALL_ALIVE)
        assert bool(elected[0]) and int(votes[0]) == 3
        assert not bool(elected[1])  # no election there
        # term bumped on granters
        assert int(state.current_term[0, 0]) == 1

    def test_stale_term_rejected(self, cfg, fns):
        state = fns.init()
        inp = make_input(cfg, appends={0: [b"m"]}, term=5)
        state, _ = fns.step(state, inp, ALL_ALIVE)
        cand = np.full((cfg.partitions,), -1, np.int32)
        cand[0] = 2
        cand_term = np.full((cfg.partitions,), 3, np.int32)  # < current term 5
        state, elected, votes = fns.vote(state, cand, cand_term, ALL_ALIVE)
        assert not bool(elected[0])
        assert int(votes[0]) == 0

    def test_out_of_date_candidate_rejected(self, cfg, fns):
        state = fns.init()
        # replicas 0,1 accumulate log; replica 2 stays empty
        state, _ = fns.step(
            state,
            make_input(cfg, appends={0: [b"m1", b"m2"]}),
            np.array([True, True, False]),
        )
        cand = np.full((cfg.partitions,), -1, np.int32)
        cand[0] = 2
        cand_term = np.full((cfg.partitions,), 7, np.int32)
        state, elected, votes = fns.vote(state, cand, cand_term, ALL_ALIVE)
        # only replica 2 itself grants (its own log is not behind itself)
        assert int(votes[0]) == 1
        assert not bool(elected[0])

    def test_up_to_date_candidate_wins_after_leader_death(self, cfg, fns):
        state = fns.init()
        state, _ = fns.step(
            state, make_input(cfg, appends={0: [b"m1"]}, term=1), ALL_ALIVE
        )
        cand = np.full((cfg.partitions,), -1, np.int32)
        cand[0] = 1
        cand_term = np.full((cfg.partitions,), 2, np.int32)
        state, elected, votes = fns.vote(
            state, cand, cand_term, np.array([False, True, True])
        )
        assert bool(elected[0]) and int(votes[0]) == 2
