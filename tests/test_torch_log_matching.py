"""Raft safety: the full log-matching check (prevLogIndex AND prevLogTerm).

A replica whose log has the same length as the leader's but whose tail was
written under a different term holds a divergent uncommitted suffix; it
must not ack AppendEntries (else divergent bytes end up below its commit
index), and must re-enter via resync. This is the equal-length
divergent-tail case of Raft §5.3 that length-only matching misses.

Twin of `tests/test_log_matching.py` on the PyTorch port: the scenario
runs through `TwinFns` (the port's engine on the CPU and the reference's
in lockstep, every output and state leaf equal after every call), and
its assertions read the port's values.
"""

import numpy as np

from tests.torch_helpers import TwinFns, make_input, port_cfg
from tests.torch_helpers import read_committed as read_all
from tests.torch_port_modules import admit

admit(__name__)

ALL = np.array([True, True, True])


def test_divergent_equal_length_tail_rejected_then_resynced():
    cfg = port_cfg()
    fns = TwinFns(cfg)
    state = fns.init()

    # Round 1: normal committed append, leader 0, term 1.
    state, out = fns.step(
        state, make_input(cfg, appends={0: [b"a0", b"a1"]}, leader=0, term=1), ALL
    )
    assert bool(out.committed[0]) and int(out.commit[0]) == 8

    # Round 2: leader 0 appends alone (followers masked dead) — uncommitted
    # divergent suffix on replica 0 only.
    state, out = fns.step(
        state,
        make_input(cfg, appends={0: [b"x0", b"x1"]}, leader=0, term=1),
        np.array([True, False, False]),
    )
    assert not bool(out.committed[0])

    # Round 3: replica 1 leads at term 2 while 0 is dead; writes DIFFERENT
    # entries over the same indices and commits with quorum {1, 2}.
    state, out = fns.step(
        state,
        make_input(cfg, appends={0: [b"y0", b"y1"]}, leader=1, term=2),
        np.array([False, True, True]),
    )
    assert bool(out.committed[0]) and int(out.commit[0]) == 16

    # Round 4: replica 0 is back. Its log_end (4) equals the leader's, but
    # its tail term is 1 vs the leader's 2 — it must NOT ack.
    state, out = fns.step(
        state, make_input(cfg, appends={0: [b"z0"]}, leader=1, term=2), ALL
    )
    assert int(out.votes[0]) == 2  # replicas 1 and 2 only
    assert bool(out.committed[0])
    # Replica 0's own commit must not advance past its consistent prefix.
    assert int(state.commit[0, 0]) == 8
    # Its divergent bytes must never be served as committed.
    got = read_all(fns, state, 0, 0)
    assert b"x0" not in got and b"x1" not in got

    # Resync replica 0 from the leader, after which it acks again.
    mask = np.zeros(cfg.partitions, bool)
    mask[0] = True
    state = fns.resync(state, np.int32(1), np.int32(0), mask)
    state, out = fns.step(
        state, make_input(cfg, appends={0: [b"w0"]}, leader=1, term=2), ALL
    )
    assert int(out.votes[0]) == 3
    got = read_all(fns, state, 0, 0)
    assert got == [b"a0", b"a1", b"y0", b"y1", b"z0", b"w0"]
