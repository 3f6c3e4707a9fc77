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
                                 "entries_width"])
def test_wrapper_validates_inputs(bad):
    rng = np.random.default_rng(6)
    log, entries, ids, base, do_write, _ = _case(rng)
    t = {k: torch.from_numpy(v) for k, v in dict(
        log=log, entries=entries, ids=ids, base=base, do_write=do_write).items()}
    if bad == "log_dtype":
        t["log"] = t["log"].to(torch.int32)
    elif bad == "ids_dtype":
        t["ids"] = t["ids"].to(torch.int64)
    elif bad == "do_write_shape":
        t["do_write"] = t["do_write"][:, :-1]
    else:
        t["entries"] = t["entries"][..., :-8]
    with pytest.raises(ValueError):
        port.append_rows_active(t["log"], t["entries"], t["ids"], t["base"],
                                t["do_write"])
