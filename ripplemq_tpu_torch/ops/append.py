"""Log-append write phase (PyTorch port): a CUDA kernel and its plain twin.

Twin of `ripplemq_tpu/ops/append.py`. Each committed round writes, for
every partition p listed in the round's active set and every replica r
that acks it, the partition's [B, SB] block of packed rows at the
physical ring position `base[p]`, in place.

- On a CUDA tensor the wrapper launches the hand-written kernel in
  `csrc/append.cu` (built by `ops.cuda_build`) on the current stream,
  with no torch op around it (the kernel computes packed classes from
  the raw extents); a build or launch failure raises.
- On a CPU tensor it runs `append_rows_active_plain`, the plain PyTorch
  version ported from the reference's `append_rows_active_xla`. Nothing
  else takes the plain path; the chip smoke run compares the two.

Semantics contract (the reference's):
- `base` is the PHYSICAL ring position (ALIGN-aligned); the window is
  the full B rows unless `extents` is given;
- packed mode (`extents`, EngineConfig.packed_writes): the window
  shrinks to the partition's extent CLASS — power-of-two ALIGN-row
  blocks >= the ALIGN-rounded extent, or the full window — and rows
  between the class and B keep their bytes;
- ids < 0 are padding; ids past P-1 clip to P-1; each partition appears
  at most once per round;
- rows that would land outside the log (base + i >= S + B) are dropped,
  as the reference's scatter drops them (`mode="drop"`).
"""

from __future__ import annotations

import ctypes

import torch

from ripplemq_tpu_torch.core.config import ALIGN
from ripplemq_tpu_torch.ops import cuda_build

# Launches of the CUDA kernel, by variant: incremented where the wrapper
# launches it and nowhere else (the plain path does not count).
LAUNCHES = {"append_active": 0, "append_active_packed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- packed extents


def _packed_classes(BA: int) -> list[int]:
    """Ascending copy-size classes in ALIGN-row blocks: powers of two
    below BA plus the full window (BA itself, whether or not it is a
    power)."""
    sizes = set()
    s = 1
    while s < BA:
        sizes.add(s)
        s *= 2
    sizes.add(BA)
    return sorted(sizes)


def _class_roundup(eb: torch.Tensor, BA: int) -> torch.Tensor:
    """Smallest class >= eb (eb in ALIGN-row blocks, clipped to [0, BA])."""
    classes = _packed_classes(BA)
    pb = torch.full_like(eb, classes[-1])
    for s in reversed(classes):
        pb = torch.where(eb <= s, torch.full_like(eb, s), pb)
    return pb


def _extent_blocks(extents: torch.Tensor, B: int) -> torch.Tensor:
    """Host row extents [P] -> ALIGN-row block counts [P], clipped."""
    return (extents.to(torch.int32).clamp(0, B) + ALIGN - 1) // ALIGN


# ------------------------------------------------------------ plain twin


def _plain_writes(log_data, entries, slot_ids, base, do_write, extents):
    """Index tensors of every row the append writes: (replica, partition,
    physical row) destinations and (entry, row) sources."""
    R, P, SP, _ = log_data.shape
    B = entries.shape[1]
    dev = log_data.device
    ids = slot_ids.to(torch.int64).clamp(0, P - 1)                 # [A]
    write = (slot_ids >= 0)[None, :] & do_write.to(torch.bool)[:, ids]  # [R, A]
    rows = torch.arange(B, dtype=torch.int64, device=dev)
    ridx = base.to(torch.int64)[ids][:, None] + rows[None, :]      # [A, B]
    in_log = (ridx >= 0) & (ridx < SP)
    if extents is not None:
        BA = B // ALIGN
        eb = _extent_blocks(extents, B).clamp(1, BA)
        rows_lim = (_class_roundup(eb, BA) * ALIGN).to(torch.int64)  # [P]
        in_log = in_log & (rows[None, :] < rows_lim[ids][:, None])
    r_i, a_i, b_i = torch.nonzero(write[:, :, None] & in_log[None],
                                  as_tuple=True)
    return r_i, ids[a_i], ridx[a_i, b_i], a_i, b_i


def append_rows_active_plain(log_data, entries, slot_ids, base, do_write,
                             extents=None):
    """Plain PyTorch active-set append, in place on `log_data`; ported
    from the reference's `append_rows_active_xla`. Its scatter drops
    out-of-log rows (`mode="drop"`); torch's `index_put_` has no drop
    mode, so such rows are masked out of the index set instead."""
    r_i, p_i, row_i, a_i, b_i = _plain_writes(
        log_data, entries, slot_ids, base, do_write, extents)
    log_data[r_i, p_i, row_i] = entries[a_i, b_i]
    return log_data


# ------------------------------------------------------------ the kernel


_STAGE_MAX = 32768  # bytes per stage of the kernel's shared ring
_STAGES = 2         # stages of the ring (csrc/append.cu kStages)
_MAX_REPLICAS = 64  # csrc/append.cu kMaxReplicas


def _chunk_bytes(B: int, SB: int) -> int:
    """Bytes per stage of the kernel's shared-memory ring: a window of
    B * SB bytes rounded up to 16 (bulk copies move multiples of 16),
    capped at `_STAGE_MAX`; a longer window streams through the ring
    chunk by chunk. At the headline shape (B * SB = 32 KiB) the window
    is one chunk and a CTA holds 64 KiB of shared memory; on the H100
    that beat rings of 16-32 KiB a CTA, although only 3 CTAs then fit an
    SM."""
    return min(_STAGE_MAX, -(-(B * SB) // 16) * 16)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ripplemq_append_active
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ctypes.c_longlong, ci,
                   ci, ci, ci, ci, vp]
    fn.restype = ci


def build() -> ctypes.CDLL:
    """Build (or load the cached) kernel library and bind its symbol."""
    lib = cuda_build.load("append")
    _bind(lib)
    return lib


def _check(log_data, entries, slot_ids, base, do_write, extents) -> None:
    if log_data.dtype != torch.uint8 or log_data.ndim != 4:
        raise ValueError("log_data must be uint8 [R, P, S+B, SB]")
    R, P, _, SB = log_data.shape
    if (entries.dtype != torch.uint8 or entries.ndim != 3
            or entries.shape[2] != SB or entries.shape[1] % ALIGN):
        raise ValueError("entries must be uint8 [A, B, SB] with B % ALIGN == 0")
    A = entries.shape[0]
    want = [(slot_ids, torch.int32, (A,), "slot_ids"),
            (base, torch.int32, (P,), "base"),
            (do_write, torch.bool, (R, P), "do_write")]
    if extents is not None:
        want.append((extents, torch.int32, (P,), "extents"))
    for t, dtype, shape, name in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
    for t, name in [(entries, "entries")] + [(w[0], w[3]) for w in want]:
        if t.device != log_data.device:
            raise ValueError(f"{name} is on {t.device}, log_data on "
                             f"{log_data.device}")


def _launch(log_data, entries, slot_ids, base, do_write, extents) -> None:
    """One kernel launch. The raw extents go to the kernel, which computes
    each partition's class itself: no torch ops run around the launch."""
    for t, name in ((log_data, "log_data"), (entries, "entries")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    R, P, SP, SB = log_data.shape
    A, B = entries.shape[0], entries.shape[1]
    if R > _MAX_REPLICAS:
        raise ValueError(f"the append kernel takes at most {_MAX_REPLICAS} "
                         f"replicas, got {R}")
    if A == 0 or B == 0:
        return
    lib = build()
    slot_ids = slot_ids.contiguous()
    base = base.contiguous()
    do_write = do_write.contiguous()
    extents = None if extents is None else extents.contiguous()
    stream = torch.cuda.current_stream(log_data.device).cuda_stream
    err = lib.ripplemq_append_active(
        log_data.data_ptr(), entries.data_ptr(), slot_ids.data_ptr(),
        base.data_ptr(), do_write.data_ptr(),
        None if extents is None else extents.data_ptr(),
        R, P, SP, SB, A, B, _chunk_bytes(B, SB), log_data.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"append kernel launch failed: cudaError {err}")
    LAUNCHES["append_active" if extents is None
             else "append_active_packed"] += 1


def append_rows_active(log_data, entries, slot_ids, base, do_write, *,
                       extents=None):
    """Active-set write phase, in place: entries [A, B, SB] carry only the
    partitions listed in slot_ids [A] (-1 = padding); base [P] physical;
    do_write [R, P]; extents [P] rows or None. Returns `log_data`.

    CUDA tensors launch the kernel; CPU tensors take the plain version;
    any other device raises."""
    _check(log_data, entries, slot_ids, base, do_write, extents)
    if log_data.device.type == "cuda":
        _launch(log_data, entries, slot_ids, base, do_write, extents)
        return log_data
    if log_data.device.type == "cpu":
        return append_rows_active_plain(log_data, entries, slot_ids, base,
                                        do_write, extents)
    raise ValueError(f"no append path for device {log_data.device}")


def append_rows(log_data, entries, base, do_write, *, extents=None):
    """Dense write: the active-set write with every partition listed
    (entries [P, B, SB], ids = arange(P)); one kernel to maintain."""
    P = log_data.shape[1]
    ids = torch.arange(P, dtype=torch.int32, device=log_data.device)
    return append_rows_active(log_data, entries, ids, base, do_write,
                              extents=extents)
