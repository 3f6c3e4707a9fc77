"""Append write phase: the port's plain version against the JAX reference.

The port's `append_rows_active` runs its plain PyTorch version on CPU
tensors (the CUDA kernel is held against that same plain version on the
card by `chip_smoke.py`). Here, on the CPU, the same numpy inputs go
through the reference's XLA fallbacks (`append_rows_active_xla`, dense
`append_rows_xla`) and, once, through the reference's Pallas kernel in
interpret mode. Every value is an integer, so the tolerance is exact
equality of every byte of the log.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripplemq_tpu.ops import append as ref
from ripplemq_tpu_torch.ops import append as port
from tests.torch_port_modules import admit

admit(__name__)

ALIGN = 8


def _case(rng, R=3, P=16, S=64, SB=32, B=16, A=12, *, overflow=False,
          clipped_id=False):
    """A seeded active-set round. `overflow` lets bases run up to the
    ring end (windows past S+B drop their tail rows); `clipped_id` lists
    one id past P-1, which the reference clips to P-1."""
    SP = S + B
    log = rng.integers(0, 256, size=(R, P, SP, SB), dtype=np.uint8)
    entries = rng.integers(0, 256, size=(A, B, SB), dtype=np.uint8)
    pool = np.arange(P - 1 if clipped_id else P)
    n_active = min(A - 1, len(pool))
    ids = np.full((A,), -1, np.int32)
    ids[rng.choice(A, n_active, replace=False)] = rng.choice(
        pool, n_active, replace=False)
    if clipped_id:
        ids[np.flatnonzero(ids < 0)[0]] = P + 3
    hi = SP // ALIGN if overflow else (SP - B) // ALIGN + 1
    base = (rng.integers(0, hi, size=(P,)) * ALIGN).astype(np.int32)
    do_write = rng.random((R, P)) < 0.6
    extents = rng.integers(-4, B + 9, size=(P,)).astype(np.int32)
    return log, entries, ids, base, do_write, extents


def _port_active(log, entries, ids, base, do_write, extents):
    t = torch.from_numpy
    out = port.append_rows_active(
        t(log.copy()), t(entries), t(ids), t(base), t(do_write),
        extents=None if extents is None else t(extents))
    return out.numpy()


@pytest.mark.parametrize("packed", [False, True], ids=["legacy", "packed"])
@pytest.mark.parametrize("seed,shape,kw", [
    (0, dict(), dict()),
    (1, dict(SB=64, B=24), dict()),                 # B/8 = 3: non-power class set
    (2, dict(R=5, P=8, A=8), dict(overflow=True)),  # tails past the ring end
    (3, dict(SB=32, B=32), dict(clipped_id=True)),
    (4, dict(R=1, P=4, S=32, B=8, A=4), dict(overflow=True)),
])
def test_plain_active_matches_reference_xla(seed, shape, kw, packed):
    rng = np.random.default_rng(seed)
    log, entries, ids, base, do_write, extents = _case(rng, **shape, **kw)
    ext = extents if packed else None
    want = np.asarray(ref.append_rows_active_xla(
        jnp.asarray(log), jnp.asarray(entries), jnp.asarray(ids),
        jnp.asarray(base), jnp.asarray(do_write),
        None if ext is None else jnp.asarray(ext)))
    got = _port_active(log, entries, ids, base, do_write, ext)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, log)  # the case really wrote rows


@pytest.mark.parametrize("packed", [False, True], ids=["legacy", "packed"])
def test_plain_dense_matches_reference_xla(packed):
    rng = np.random.default_rng(7)
    R, P, S, SB, B = 3, 8, 64, 32, 16
    log = rng.integers(0, 256, size=(R, P, S + B, SB), dtype=np.uint8)
    entries = rng.integers(0, 256, size=(P, B, SB), dtype=np.uint8)
    base = (rng.integers(0, S // ALIGN + 1, size=(P,)) * ALIGN).astype(np.int32)
    do_write = rng.random((R, P)) < 0.6
    ext = rng.integers(0, B + 1, size=(P,)).astype(np.int32) if packed else None
    want = np.asarray(ref.append_rows_xla(
        jnp.asarray(log), jnp.asarray(entries), jnp.asarray(base),
        jnp.asarray(do_write), None if ext is None else jnp.asarray(ext)))
    t = torch.from_numpy
    got = port.append_rows(t(log.copy()), t(entries), t(base), t(do_write),
                           extents=None if ext is None else t(ext)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True], ids=["legacy", "packed"])
def test_plain_active_matches_reference_pallas_interpret(packed):
    """One small case through the reference's Pallas kernel itself (the
    Mosaic interpreter, as tests/test_append_kernel.py runs it); bases
    keep the kernel's contract base + B <= S + B."""
    rng = np.random.default_rng(11)
    log, entries, ids, base, do_write, extents = _case(
        rng, R=2, P=4, S=32, SB=32, B=32, A=4)
    ext = extents if packed else None
    want = np.asarray(ref._append_active_pallas(
        jnp.asarray(log), jnp.asarray(entries), jnp.asarray(ids),
        jnp.asarray(base), jnp.asarray(do_write),
        extents=None if ext is None else jnp.asarray(ext), interpret=True))
    got = _port_active(log, entries, ids, base, do_write, ext)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("BA", [1, 2, 3, 4, 5, 8, 17, 32])
def test_packed_class_rule_matches_reference(BA):
    assert port._packed_classes(BA) == ref._packed_classes(BA)
    eb = np.arange(0, BA + 1, dtype=np.int32)
    want = np.asarray(ref._class_roundup(jnp.asarray(eb), BA))
    got = port._class_roundup(torch.from_numpy(eb), BA).numpy()
    np.testing.assert_array_equal(got, want)
    ext = np.arange(-9, 8 * BA + 9, dtype=np.int32)
    np.testing.assert_array_equal(
        port._extent_blocks(torch.from_numpy(ext), 8 * BA).numpy(),
        np.asarray(ref._extent_blocks(jnp.asarray(ext), 8 * BA)))


def test_plain_path_does_not_count_kernel_launches():
    port.reset_launches()
    rng = np.random.default_rng(5)
    _port_active(*_case(rng))
    assert port.LAUNCHES == {"append_active": 0, "append_active_packed": 0}


@pytest.mark.parametrize("bad", ["log_dtype", "ids_dtype", "do_write_shape",
                                 "entries_width", "extents_dtype",
                                 "extents_shape"])
def test_wrapper_validates_inputs(bad):
    rng = np.random.default_rng(6)
    log, entries, ids, base, do_write, extents = _case(rng)
    t = {k: torch.from_numpy(v) for k, v in dict(
        log=log, entries=entries, ids=ids, base=base, do_write=do_write,
        extents=extents).items()}
    ext = None
    if bad == "extents_dtype":
        ext = t["extents"].to(torch.int64)
    elif bad == "extents_shape":
        ext = t["extents"][:-1]
    elif bad == "log_dtype":
        t["log"] = t["log"].to(torch.int32)
    elif bad == "ids_dtype":
        t["ids"] = t["ids"].to(torch.int64)
    elif bad == "do_write_shape":
        t["do_write"] = t["do_write"][:, :-1]
    else:
        t["entries"] = t["entries"][..., :-8]
    with pytest.raises(ValueError):
        port.append_rows_active(t["log"], t["entries"], t["ids"], t["base"],
                                t["do_write"], extents=ext)


# ------------------------------------------------- the kernel's arithmetic
# The CUDA kernel cannot run here; these mirror, line for line, what
# csrc/append.cu computes per CTA, and hold it against the plain version.


def _kernel_rows(ext: int, B: int) -> int:
    """csrc/append.cu `extent_class`: raw extent -> rows written."""
    ba = B // ALIGN
    ext = min(max(ext, 0), B)
    eb = min(max((ext + ALIGN - 1) // ALIGN, 1), ba)
    c = 1
    while c < eb:
        c <<= 1
    return ALIGN * (ba if c >= ba else c)


def _kernel_model(log, entries, ids, base, do_write, extents, chunk):
    """The kernel's copy in numpy: per active entry the window clipped to
    [0, SP), streamed chunk by chunk as flat bytes to every writing
    replica, exactly as the bulk and register paths move it."""
    log = log.copy()
    R, P, SP, SB = log.shape
    B = entries.shape[1]
    flat_log = log.reshape(-1)
    flat_ent = entries.reshape(-1)
    for a, p in enumerate(ids):
        if p < 0:
            continue
        p = min(int(p), P - 1)
        writers = [r for r in range(R) if do_write[r, p]]
        if not writers:
            continue
        rows = B if extents is None else _kernel_rows(int(extents[p]), B)
        b0 = int(base[p])
        lo, hi = max(0, -b0), min(rows, SP - b0)
        if hi <= lo:
            continue
        nbytes = (hi - lo) * SB
        src = (a * B + lo) * SB
        dst0 = (p * SP + b0 + lo) * SB
        for off in range(0, nbytes, chunk):
            size = min(chunk, nbytes - off)
            for r in writers:
                d = r * P * SP * SB + dst0 + off
                flat_log[d:d + size] = flat_ent[src + off:src + off + size]
    return log


@pytest.mark.parametrize("B", [8, 16, 24, 64, 256])
def test_kernel_class_from_raw_extents_matches_plain_rows(B):
    """The packed class the kernel computes from raw int32 extents (the
    wrapper no longer runs `_extent_blocks` before the launch) equals the
    plain version's row limit, and the reference's, for every extent."""
    ext = np.arange(-9, B + 10, dtype=np.int32)
    BA = B // ALIGN
    plain = port._class_roundup(
        port._extent_blocks(torch.from_numpy(ext), B).clamp(1, BA), BA) * ALIGN
    ref_rows = np.asarray(ref._class_roundup(
        jnp.clip(ref._extent_blocks(jnp.asarray(ext), B), 1, BA), BA)) * ALIGN
    got = [_kernel_rows(int(e), B) for e in ext]
    assert got == plain.tolist() == ref_rows.tolist()


@pytest.mark.parametrize("packed", [False, True], ids=["legacy", "packed"])
@pytest.mark.parametrize("seed,shape,kw", [
    (0, dict(), dict()),
    (1, dict(SB=24, B=24), dict(overflow=True)),
    (2, dict(SB=25, B=16), dict(overflow=True, clipped_id=True)),
    (3, dict(R=5, P=8, A=8, SB=128, B=64), dict(overflow=True)),
])
@pytest.mark.parametrize("stage", [16, 48, 32768])
def test_kernel_window_and_chunk_plan_match_plain(seed, shape, kw, packed,
                                                  stage, monkeypatch):
    """The kernel's window clipping and the wrapper's chunk plan (at the
    real cap and at caps that split windows into many chunks, some
    ragged) write exactly the plain version's rows, bases before row 0
    and past the ring end included."""
    monkeypatch.setattr(port, "_STAGE_MAX", stage)
    rng = np.random.default_rng(seed)
    log, entries, ids, base, do_write, extents = _case(rng, **shape, **kw)
    base = base - ALIGN * rng.integers(0, 3, size=base.shape).astype(np.int32)
    ext = extents if packed else None
    B, SB = entries.shape[1], entries.shape[2]
    chunk = port._chunk_bytes(B, SB)
    assert chunk % 16 == 0 and 0 < chunk <= max(stage, 16)
    got = _kernel_model(log, entries, ids, base, do_write, ext, chunk)
    want = _port_active(log, entries, ids, base, do_write, ext)
    np.testing.assert_array_equal(got, want)


def test_chunk_plan_fits_the_card():
    """A CTA's ring (`_STAGES` chunks) fits the 227 KB of shared memory a
    block may use; the headline window (B 256 x SB 128) is one chunk."""
    for B, SB in [(256, 128), (8, 9), (1024, 1024), (32, 24)]:
        chunk = port._chunk_bytes(B, SB)
        assert chunk % 16 == 0 and chunk >= min(B * SB, port._STAGE_MAX)
        assert port._STAGES * chunk <= 232448
    assert port._chunk_bytes(256, 128) == 256 * 128
