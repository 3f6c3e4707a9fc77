"""Control, vote and read steps: the port against the JAX reference.

The reference writes each step for one replica and adds the replica axis
with `jax.vmap(..., axis_name="replica")`; the port keeps the axis
explicit. The same seeded numpy states and inputs — including the
host-fed garbage the reference sanitizes (oversized and negative counts,
out-of-range leaders, per-partition alive masks, duplicate offset slots)
— go through both, in both state layouts. All values are integers:
the tolerance is exact equality.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripplemq_tpu.core import state as ref_state
from ripplemq_tpu.core import step as ref_step
from ripplemq_tpu.core.config import EngineConfig as RefConfig
from ripplemq_tpu_torch.core import state as port_state
from ripplemq_tpu_torch.core import step as port_step
from ripplemq_tpu_torch.core.config import EngineConfig
from tests.torch_port_modules import admit

admit(__name__)

SHAPE = dict(partitions=16, replicas=3, slots=64, slot_bytes=32,
             max_batch=16, read_batch=8, max_consumers=6,
             max_offset_updates=4)


def _cfgs(**kw):
    return EngineConfig(**SHAPE, **kw), RefConfig(**SHAPE, **kw)


def _rand_state(rng, cfg):
    """[R, ...] state whose replicas mostly agree with a random leader
    view, so log matching passes and fails in the same draw."""
    R, P, S, B = cfg.replicas, cfg.partitions, cfg.slots, cfg.max_batch
    base = rng.integers(0, (S - B) // 8 + 1, size=P) * 8
    lterm = rng.integers(0, 3, size=P)
    agree = rng.random((R, P)) < 0.75
    log_end = np.where(agree, base, rng.integers(0, S // 8, size=(R, P)) * 8)
    last_term = np.where(agree | (rng.random((R, P)) < 0.5), lterm,
                         rng.integers(0, 3, size=(R, P)))
    return dict(
        log_data=rng.integers(0, 256, size=(R, P, S + B, cfg.slot_bytes),
                              dtype=np.uint8),
        log_end=log_end.astype(np.int32),
        last_term=last_term.astype(np.int32),
        current_term=rng.integers(0, 4, size=(R, P)).astype(np.int32),
        commit=(log_end - rng.integers(0, 2, size=(R, P)) * 8).clip(0)
        .astype(np.int32),
        offsets=rng.integers(0, 50, size=(R, P, cfg.max_consumers))
        .astype(np.int32),
    )


def _rand_input(rng, cfg, extents=True):
    P, B, U, C = (cfg.partitions, cfg.max_batch, cfg.max_offset_updates,
                  cfg.max_consumers)
    counts = rng.integers(-2, B + 6, size=P)
    counts[rng.random(P) < 0.25] = 0
    return dict(
        entries=rng.integers(0, 256, size=(P, B, cfg.slot_bytes), dtype=np.uint8),
        counts=counts.astype(np.int32),
        off_slots=rng.integers(0, C + 2, size=(P, U)).astype(np.int32),
        off_vals=rng.integers(0, 1000, size=(P, U)).astype(np.int32),
        off_counts=rng.integers(-1, U + 3, size=P).astype(np.int32),
        leader=np.where(rng.random(P) < 0.8,
                        rng.integers(0, cfg.replicas, size=P),
                        rng.choice([-1, cfg.replicas], size=P)).astype(np.int32),
        term=rng.integers(1, 6, size=P).astype(np.int32),
        extents=(rng.integers(-3, B + 9, size=P).astype(np.int32)
                 if extents else None),
    )


def _rand_alive(rng, cfg, per_partition):
    shape = ((cfg.partitions, cfg.replicas) if per_partition
             else (cfg.replicas,))
    return rng.random(shape) < 0.8


def _t(tree):
    return {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: None if v is None else jnp.asarray(v) for k, v in tree.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_replica_invariant_eq(got, want):
    want = np.asarray(want)
    assert (want == want[:1]).all(), "reference output not replica-invariant"
    np.testing.assert_array_equal(_np(got), want[0])


VARIANTS = {
    "legacy": {},
    "fused": dict(fused_control=True),
    "packed": dict(packed_writes=True),
    "fused+packed": dict(fused_control=True, packed_writes=True),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", range(6))
def test_control_matches_reference(variant, seed):
    rng = np.random.default_rng(seed)
    cfg, rcfg = _cfgs(**VARIANTS[variant])
    st = _rand_state(rng, cfg)
    inp = _rand_input(rng, cfg, extents=seed % 3 != 0)
    alive = _rand_alive(rng, cfg, per_partition=seed % 2 == 1)
    quorum = (rng.integers(1, cfg.replicas + 1, size=cfg.partitions)
              .astype(np.int32) if seed % 2 else None)
    trim = (rng.integers(0, 48, size=cfg.partitions).astype(np.int32)
            if seed >= 3 else None)
    fused = cfg.fused_control

    jst = ref_state.ReplicaState(**_j(st))
    pst = port_state.ReplicaState(**_t(st))
    if fused:
        jst, pst = ref_state.fuse_state(jst), port_state.fuse_state(pst)
    ctrl_ref = (ref_step.replica_control_fused if fused
                else ref_step.replica_control)
    ctrl_port = (port_step.replica_control_fused if fused
                 else port_step.replica_control)
    vctrl = jax.vmap(functools.partial(ctrl_ref, rcfg),
                     in_axes=(0, None, 0, None, None, None),
                     axis_name=ref_step.AXIS)
    maybe = lambda x, f: None if x is None else f(x)  # noqa: E731
    jnew, jctl = vctrl(jst, ref_state.StepInput(**_j(inp)),
                       jnp.arange(cfg.replicas, dtype=jnp.int32),
                       jnp.asarray(alive), maybe(quorum, jnp.asarray),
                       maybe(trim, jnp.asarray))
    pnew, pctl = ctrl_port(cfg, pst, port_state.StepInput(**_t(inp)),
                           torch.from_numpy(alive),
                           maybe(quorum, torch.from_numpy),
                           maybe(trim, torch.from_numpy))

    for name in jnew._fields:
        if name != "log_data":
            np.testing.assert_array_equal(_np(getattr(pnew, name)),
                                          np.asarray(getattr(jnew, name)),
                                          err_msg=name)
    for name in jctl.out._fields:
        _assert_replica_invariant_eq(getattr(pctl.out, name),
                                     getattr(jctl.out, name))
    np.testing.assert_array_equal(_np(pctl.do_write), np.asarray(jctl.do_write))
    _assert_replica_invariant_eq(pctl.extent, jctl.extent)
    # The draw exercised both outcomes.
    assert 0 < int(pctl.out.committed.sum()) < cfg.partitions


def test_offset_blend_is_ordered_later_duplicate_wins():
    cfg, _ = _cfgs()
    R, P, C = cfg.replicas, cfg.partitions, cfg.max_consumers
    offsets = torch.zeros((R, P, C), dtype=torch.int32)
    inp = port_state.StepInput(
        entries=None, counts=torch.zeros(P, dtype=torch.int32),
        off_slots=torch.tensor([[2, 2, 1, 2]] * P, dtype=torch.int32),
        off_vals=torch.tensor([[10, 20, 30, 40]] * P, dtype=torch.int32),
        off_counts=torch.full((P,), 3, dtype=torch.int32),
        leader=None, term=None)
    do_write = torch.ones((R, P), dtype=torch.bool)
    do_write[1, 0] = False
    out = port_step._blend_offsets(cfg, offsets, inp, do_write)
    assert out[0, 0, 2] == 20 and out[0, 0, 1] == 30  # 4th update not counted
    assert out[1, 0].eq(0).all()


@pytest.mark.parametrize("packed", [False, True], ids=["legacy", "packed"])
@pytest.mark.parametrize("seed", range(4))
def test_replica_step_matches_reference(packed, seed):
    """The all-in-one round (control phase + the plain append at
    `base % slots`) against the reference's `jax.vmap(replica_step)`:
    every state leaf, the written log included, and every output."""
    rng = np.random.default_rng(200 + seed)
    cfg, rcfg = _cfgs(packed_writes=packed)
    st = _rand_state(rng, cfg)
    inp = _rand_input(rng, cfg, extents=seed % 2 == 0)
    alive = _rand_alive(rng, cfg, per_partition=seed % 2 == 1)
    quorum = (rng.integers(1, cfg.replicas + 1, size=cfg.partitions)
              .astype(np.int32) if seed >= 2 else None)
    trim = (rng.integers(0, 48, size=cfg.partitions).astype(np.int32)
            if seed % 2 else None)
    if seed % 2:
        # A lapped ring: absolute offsets one ring past the physical rows
        # (trim moves with them), so the write lands at base % slots.
        for name in ("log_end", "commit"):
            st[name] = st[name] + np.int32(cfg.slots)
        trim = trim + np.int32(cfg.slots)
    maybe = lambda x, f: None if x is None else f(x)  # noqa: E731

    vstep = jax.vmap(functools.partial(ref_step.replica_step, rcfg),
                     in_axes=(0, None, 0, None, None, None),
                     axis_name=ref_step.AXIS)
    jnew, jout = vstep(ref_state.ReplicaState(**_j(st)),
                       ref_state.StepInput(**_j(inp)),
                       jnp.arange(cfg.replicas, dtype=jnp.int32),
                       jnp.asarray(alive), maybe(quorum, jnp.asarray),
                       maybe(trim, jnp.asarray))
    pnew, pout = port_step.replica_step(
        cfg, port_state.ReplicaState(**_t(st)),
        port_state.StepInput(**_t(inp)), torch.from_numpy(alive),
        maybe(quorum, torch.from_numpy), maybe(trim, torch.from_numpy))

    for name in jnew._fields:
        np.testing.assert_array_equal(_np(getattr(pnew, name)),
                                      np.asarray(getattr(jnew, name)),
                                      err_msg=name)
    for name in jout._fields:
        _assert_replica_invariant_eq(getattr(pout, name),
                                     getattr(jout, name))
    # The draw wrote rows: the log changed where a round committed.
    assert (pnew.log_data.numpy() != st["log_data"]).any()
    assert 0 < int(pout.committed.sum()) < cfg.partitions


@pytest.mark.parametrize("fused", [False, True], ids=["legacy", "fused"])
@pytest.mark.parametrize("seed", range(4))
def test_vote_matches_reference(fused, seed):
    rng = np.random.default_rng(100 + seed)
    cfg, rcfg = _cfgs(fused_control=fused)
    st = _rand_state(rng, cfg)
    P, R = cfg.partitions, cfg.replicas
    cand = rng.integers(-1, R + 1, size=P).astype(np.int32)
    cand_term = rng.integers(0, 6, size=P).astype(np.int32)
    alive = _rand_alive(rng, cfg, per_partition=seed % 2 == 0)
    quorum = (rng.integers(1, R + 1, size=P).astype(np.int32)
              if seed >= 2 else None)

    jst = ref_state.ReplicaState(**_j(st))
    pst = port_state.ReplicaState(**_t(st))
    if fused:
        jst, pst = ref_state.fuse_state(jst), port_state.fuse_state(pst)
    vote_ref = ref_step.vote_step_fused if fused else ref_step.vote_step
    vote_port = port_step.vote_step_fused if fused else port_step.vote_step
    jnew, jel, jvotes = jax.vmap(
        functools.partial(vote_ref, rcfg),
        in_axes=(0, None, None, 0, None, None), axis_name=ref_step.AXIS,
    )(jst, jnp.asarray(cand), jnp.asarray(cand_term),
      jnp.arange(R, dtype=jnp.int32), jnp.asarray(alive),
      None if quorum is None else jnp.asarray(quorum))
    pnew, pel, pvotes = vote_port(
        cfg, pst, torch.from_numpy(cand), torch.from_numpy(cand_term),
        torch.from_numpy(alive),
        None if quorum is None else torch.from_numpy(quorum))
    np.testing.assert_array_equal(_np(pnew.current_term),
                                  np.asarray(jnew.current_term))
    if fused:
        np.testing.assert_array_equal(_np(pnew.ctrl), np.asarray(jnew.ctrl))
    _assert_replica_invariant_eq(pel, jel)
    _assert_replica_invariant_eq(pvotes, jvotes)


# --------------------------------------------------------------- reads

READ_SHAPES = {
    # RB <= B and RB > B (the consume bench reads 128-row windows over
    # 32-row rounds); both read across the ring end.
    "rb<b": dict(partitions=4, replicas=3, slots=64, slot_bytes=32,
                 max_batch=16, read_batch=8),
    "rb>b": dict(partitions=4, replicas=3, slots=64, slot_bytes=32,
                 max_batch=8, read_batch=40),
}


def _read_queries(cfg):
    """(replica, partition, offset) queries covering: a wrap past the ring
    end, reads straddling `commit`, negative offsets, offsets past commit,
    and out-of-range replica/partition ids (clipped)."""
    S, R, P = cfg.slots, cfg.replicas, cfg.partitions
    q = []
    for r in (-2, 0, 1, R - 1, R + 3):
        for p in (-1, 0, 1, P - 1, P + 5):
            for off in (-17, 0, 3, S - 5, S - 3, S - 1, S, S + 1, S + 7,
                        2 * S - 3, 3 * S - 2, 5 * S):
                q.append((r, p, off))
    return [np.array(col, np.int32) for col in zip(*q)]


@pytest.mark.parametrize("shape", READ_SHAPES)
def test_read_batch_at_matches_reference(shape):
    rng = np.random.default_rng(3)
    cfg, rcfg = EngineConfig(**READ_SHAPES[shape]), RefConfig(**READ_SHAPES[shape])
    R, P, S, B, SB = (cfg.replicas, cfg.partitions, cfg.slots, cfg.max_batch,
                      cfg.slot_bytes)
    log = rng.integers(0, 256, size=(R, P, S + B, SB), dtype=np.uint8)
    commit = rng.integers(0, 3 * S, size=(R, P)).astype(np.int32)
    commit[0, 0] = 0
    commit[1, 1] = S + 4
    reps, parts, offs = _read_queries(cfg)

    jlog, jcommit = jnp.asarray(log), jnp.asarray(commit)
    want = jax.jit(jax.vmap(lambda r, p, o: ref_step.read_batch_at(
        rcfg, jlog, jcommit, r, p, o)))(
        jnp.asarray(reps), jnp.asarray(parts), jnp.asarray(offs))
    got = port_step.read_batch_at(cfg, torch.from_numpy(log),
                                  torch.from_numpy(commit),
                                  torch.from_numpy(reps),
                                  torch.from_numpy(parts),
                                  torch.from_numpy(offs))
    for g, w, name in zip(got, want, ("rows", "lens", "count")):
        assert g.dtype == {"rows": torch.uint8}.get(name, torch.int32)
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    counts = np.asarray(want[2])
    assert (counts == cfg.read_batch).any() and (counts == 0).any()
    assert ((counts > 0) & (counts < cfg.read_batch)).any()


def test_single_replica_read_and_read_offset_match_reference():
    rng = np.random.default_rng(4)
    cfg, rcfg = _cfgs()
    st = _rand_state(rng, cfg)
    one = {k: v[1] for k, v in st.items()}
    jone = ref_state.ReplicaState(**_j(one))
    pone = port_state.ReplicaState(**_t(one))
    for p, off in ((0, 0), (3, 8), (-2, 5), (cfg.partitions + 1, -4)):
        want = ref_step.read_batch(rcfg, jone, jnp.int32(p), jnp.int32(off))
        got = port_step.read_batch(cfg, pone, p, off)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    for p, c in ((0, 0), (5, 3), (-1, 99), (cfg.partitions + 4, -3)):
        want = ref_step.read_offset(jone, jnp.int32(p), jnp.int32(c))
        assert int(port_step.read_offset(pone, p, c)) == int(want)


def test_state_helpers_match_reference():
    rng = np.random.default_rng(9)
    cfg, _ = _cfgs()
    st = _rand_state(rng, cfg)
    pst = port_state.ReplicaState(**_t(st))
    fused = port_state.fuse_state(pst)
    np.testing.assert_array_equal(
        fused.ctrl.numpy(),
        np.asarray(ref_state.fuse_state(ref_state.ReplicaState(**_j(st))).ctrl))
    back = port_state.unfuse_state(fused)
    for name in pst._fields:
        assert torch.equal(getattr(back, name), getattr(pst, name))
    rows = rng.integers(0, 256, size=(5, 7, cfg.slot_bytes), dtype=np.uint8)
    for fn in ("row_lens", "row_terms"):
        np.testing.assert_array_equal(
            getattr(port_state, fn)(torch.from_numpy(rows)).numpy(),
            np.asarray(getattr(ref_state, fn)(jnp.asarray(rows))))
    alive = np.array([True, False, True])
    np.testing.assert_array_equal(
        port_step._normalize_alive(torch.from_numpy(alive), 4, 3).numpy(),
        np.asarray(ref_step._normalize_alive(jnp.asarray(alive), 4, 3)))
    empty = port_state.empty_input(cfg, "cpu")
    ref_empty = ref_state.empty_input(RefConfig(**SHAPE))
    for name in ref_empty._fields:
        np.testing.assert_array_equal(getattr(empty, name).numpy(),
                                      np.asarray(getattr(ref_empty, name)))
