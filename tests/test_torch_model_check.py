"""Randomized model check: the port's engine against a pure-Python model
and against the reference engine.

Hundreds of random rounds — appends of random sizes, offset commits,
liveness-mask flips, elections (including lagging candidates that must
be refused), host-driven resyncs of lagged replicas, ring wraps under
monotone trims — with the device compared to an independent Python
reimplementation of the rules after every step.

Twin of `tests/test_model_check.py` on the PyTorch port: the same seeds
and the reference's own `Model` (the oracle), with the engine driven
through `TwinFns` — the port's `make_local_fns(cfg, device="cpu")` and
the reference's engine in lockstep, every output and state leaf equal
after every call — so the port is held to the model and to the
reference at once.
"""

from __future__ import annotations

import numpy as np
import pytest

from ripplemq_tpu_torch.core.encode import decode_entries
from tests.test_model_check import Model
from tests.torch_helpers import TwinFns, make_input, port_cfg
from tests.torch_port_modules import admit

admit(__name__)


@pytest.mark.parametrize("seed", range(4))
def test_randomized_rounds_match_model(seed):
    rng = np.random.default_rng(seed)
    cfg = port_cfg(partitions=4, replicas=3, slots=32, max_batch=8,
                   read_batch=8)
    fns = TwinFns(cfg)
    state = fns.init()
    model = Model(cfg)
    P, R, S, B = cfg.partitions, cfg.replicas, cfg.slots, cfg.max_batch

    leader = [0] * P
    term = [1] * P
    trim = np.zeros((P,), np.int64)
    msg_id = 0

    for round_i in range(120):
        alive = np.ones((R,), bool)
        if rng.random() < 0.3:
            dead = rng.choice(R, size=rng.integers(1, R), replace=False)
            alive[dead] = False

        # Occasional host repair: resync lagged replicas from the most
        # advanced one (the production lag-repair duty).
        if rng.random() < 0.25:
            for p in range(P):
                src = int(np.argmax(model.end[:, p]))
                for dst in range(R):
                    if model.end[dst, p] < model.end[src, p] or (
                        model.commit[dst, p] < model.commit[src, p]
                    ):
                        mask = np.zeros((P,), bool)
                        mask[p] = True
                        state = fns.resync(state, np.int32(src),
                                           np.int32(dst), mask)
                        model.resync(p, src, dst)

        # Occasional election attempt — candidate may be lagging, in
        # which case the up-to-date check must refuse it.
        if rng.random() < 0.25:
            p = int(rng.integers(0, P))
            cand = int(rng.integers(0, R))
            new_term = int(model.current_term[:, p].max()) + 1
            cand_arr = np.full((P,), -1, np.int32)
            cterm = np.zeros((P,), np.int32)
            cand_arr[p], cterm[p] = cand, new_term
            state, elected, votes = fns.vote(state, cand_arr, cterm, alive)
            m_elected, m_grants = model.vote(p, cand, new_term, alive)
            assert bool(np.asarray(elected)[p]) == m_elected, (
                f"round {round_i}: election mismatch p{p}"
            )
            assert int(np.asarray(votes)[p]) == m_grants
            if m_elected:
                leader[p], term[p] = cand, new_term

        # Random appends/offset commits on a random subset of partitions.
        appends, offs = {}, {}
        for p in range(P):
            lead_end = int(model.end[leader[p], p])
            if rng.random() < 0.6:
                n = int(rng.integers(1, B + 1))
                room = S - lead_end % S
                n = min(n, room)  # host contract: never lap the boundary
                appends[p] = [b"m%05d" % (msg_id + j) for j in range(n)]
                msg_id += n
            if rng.random() < 0.3:
                offs[p] = [(int(rng.integers(0, cfg.max_consumers)),
                            int(rng.integers(0, 1000)))]
        if not appends and not offs:
            continue
        # Raise trims lazily like the drain (never above the committed/
        # persisted prefix).
        for p in appends:
            needed = int(model.end[leader[p], p]) + B - S
            persisted = int(model.commit[:, p].max())
            if needed > trim[p]:
                trim[p] = min(needed, persisted)
        inp = make_input(
            cfg, appends=appends, offset_updates=offs,
            leader={p: leader[p] for p in range(P)},
            term={p: term[p] for p in range(P)},
        )
        state, out = fns.step(state, inp, alive, None,
                              trim.astype(np.int32))
        base = np.asarray(out.base)
        votes = np.asarray(out.votes)
        committed = np.asarray(out.committed)
        for p in range(P):
            mb, mv, mc = model.step(
                p, appends.get(p, []), offs.get(p, []),
                leader[p], term[p], alive, int(trim[p]),
            )
            assert (int(votes[p]), bool(committed[p])) == (mv, mc), (
                f"round {round_i} p{p}: device votes/committed "
                f"({int(votes[p])},{bool(committed[p])}) != model ({mv},{mc})"
            )
            if mc and appends.get(p):
                assert int(base[p]) == mb, f"round {round_i} p{p}: base"

        # Random committed reads above trim must match, per replica.
        for _ in range(2):
            p = int(rng.integers(0, P))
            r = int(rng.integers(0, R))
            lo = int(trim[p])
            hi = int(model.commit[r, p])
            if hi <= lo:
                continue
            off = int(rng.integers(lo, hi))
            data, lens, count = fns.read(state, r, p, off)
            got = decode_entries(data, lens, count)
            want, wcount = model.read(p, r, off)
            assert int(count) == wcount and got == want, (
                f"round {round_i} p{p} r{r} read@{off}"
            )

    # Final: full committed history (above trim) matches on the most
    # advanced replica, and the offset tables agree replica-by-replica.
    for p in range(P):
        r = int(np.argmax(model.commit[:, p]))
        off = int(trim[p])
        got = []
        while off < int(model.commit[r, p]):
            data, lens, count = fns.read(state, r, p, off)
            if int(count) == 0:
                break
            got.extend(decode_entries(data, lens, count))
            off += int(count)
        want = [
            m for m in model.rows[p][int(trim[p]):int(model.commit[r, p])]
            if m
        ]
        assert got == want
        for rr in range(R):
            for cs in range(cfg.max_consumers):
                assert int(fns.read_offset(state, rr, p, cs)) == int(
                    model.offsets[rr, p, cs]
                ), (p, rr, cs)
