"""Segment store, erasure protection and recovery: the port against the
JAX reference.

The same records go through the reference's `SegmentStore` (Python
writer) and the port's (native and Python writers): segment files must
be byte-equal. Shards written by the port's `protect_store` (the plain
GF(2⁸) version, `device="cpu"`) must be byte-equal to the reference's,
and the repair scenarios of `tests/test_rs.py` must repair the same
segments to the same bytes. `recover_image` of both packages over the
same store must give the same image, leaf for leaf, and the same gap and
producer tables. Exact throughout.
"""

from __future__ import annotations

import itertools
import os
import pathlib
import shutil
import struct

import numpy as np
import pytest

from ripplemq_tpu.broker.dataplane import recover_image as ref_recover
from ripplemq_tpu.core.config import EngineConfig as RefConfig
from ripplemq_tpu.storage import erasure as ref_er
from ripplemq_tpu.storage import segment as ref_seg
from ripplemq_tpu_torch import convert
from ripplemq_tpu_torch.broker.dataplane import recover_image
from ripplemq_tpu_torch.core.config import EngineConfig
from ripplemq_tpu_torch.storage import erasure as er
from ripplemq_tpu_torch.storage import segment as seg
from tests.torch_port_modules import admit

admit(__name__)

CPU = dict(device="cpu")
SMALL = dict(partitions=4, replicas=3, slots=64, slot_bytes=32, max_batch=8,
             read_batch=8, max_consumers=8, max_offset_updates=4)


def _records(seed, n=40, size=256):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 6)), int(rng.integers(0, 4)), i,
             rng.integers(0, 256, size=int(rng.integers(0, size)),
                          dtype=np.uint8).tobytes()) for i in range(n)]


def _write(store_cls, directory, records, *, batch=False, **kw):
    store = store_cls(directory, segment_bytes=kw.pop("segment_bytes", 1024),
                      **kw)
    locs = []
    if batch:
        for i in range(0, len(records), 5):
            locs += store.append_many(records[i:i + 5])
            store.flush()
    else:
        for rec in records:
            locs.append(store.append(*rec))
    store.close()
    return locs


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


def _filled(tmp_path, name="segments", rounds=40, segment_bytes=4096):
    """tests/test_rs.py `_fill_store`, seeded: one store, sealed segments."""
    store_dir = str(tmp_path / name)
    rng = np.random.default_rng(rounds)
    store = seg.SegmentStore(store_dir, segment_bytes=segment_bytes,
                             use_native=False)
    for i in range(rounds):
        store.append(seg.REC_APPEND, i % 4, i,
                     rng.integers(0, 256, 256, dtype=np.uint8).tobytes())
    store.close()
    return store_dir


def _twin(store_dir, tmp_path):
    """A byte copy of a store for the reference to work on."""
    dst = str(tmp_path / "ref_copy")
    shutil.copytree(store_dir, dst)
    return dst


# ------------------------------------------------------------------ store


@pytest.mark.parametrize("batch", [False, True], ids=["append", "append_many"])
def test_segment_files_byte_equal_native_python_and_reference(tmp_path, batch):
    if not seg.native_available():
        pytest.fail("g++ is present here, so the native store must build")
    records = _records(1)
    dirs = {k: str(tmp_path / k) for k in ("native", "python", "ref")}
    locs = [
        _write(seg.SegmentStore, dirs["native"], records, batch=batch,
               use_native=True),
        _write(seg.SegmentStore, dirs["python"], records, batch=batch,
               use_native=False),
        _write(ref_seg.SegmentStore, dirs["ref"], records, batch=batch,
               use_native=False),
    ]
    assert locs[0] == locs[1] == locs[2]
    files = [_files(d) for d in dirs.values()]
    assert len(files[0]) > 3  # the writes rotated through sealed segments
    assert files[0] == files[1] == files[2]
    for use_native in (True, False):
        assert list(seg.scan_store(dirs["native"], use_native)) == records
        assert (list(seg.scan_store_indexed(dirs["native"], use_native))
                == list(ref_seg.scan_store_indexed(dirs["ref"], False)))
    assert seg.verify_store(dirs["native"]) == len(records)


def test_native_library_builds_into_the_port_build_dir():
    """Keyed by a source hash, never next to the shared source (where the
    reference builds its own copy)."""
    if not seg.native_available():
        pytest.fail("g++ is present here, so the native store must build")
    loaded = pathlib.Path(seg._load_native()._name)
    assert loaded.parent == seg.BUILD_DIR
    assert loaded.name.startswith("libsegstore-") and len(loaded.name) == 31


def test_torn_tail_verify_and_gc_floor_like_reference(tmp_path):
    records = _records(2, n=30)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write(seg.SegmentStore, a, records, use_native=False)
    _write(ref_seg.SegmentStore, b, records, use_native=False)
    for d in (a, b):
        last = seg.list_segment_files(d)[-1]
        with open(os.path.join(d, last), "ab") as f:
            f.write(b"\x52\x51\x4c\x47torn")
    assert seg.verify_store(a, repair_torn_tail=True) == ref_seg.verify_store(
        b, repair_torn_tail=True)
    assert _files(a) == _files(b)
    # mid-store rot refuses in both
    for d, mod in ((a, seg), (b, ref_seg)):
        first = mod.list_segment_files(d)[0]
        with open(os.path.join(d, first), "r+b") as f:
            f.seek(30)
            f.write(b"\xff")
        with pytest.raises(mod.CorruptStoreError):
            mod.verify_store(d)
    assert seg.gc_floor(a) == ref_seg.gc_floor(b) == 0


def test_retention_gc_deletes_the_same_segments(tmp_path):
    records = _records(3, n=60)
    dirs = []
    for mod, name in ((seg, "port"), (ref_seg, "ref")):
        d = str(tmp_path / name)
        store = mod.SegmentStore(d, segment_bytes=2048, use_native=False,
                                 retention_bytes=4096)
        for rec in records:
            store.append(*rec)
        deleted = store.gc()
        store.close()
        dirs.append((d, deleted))
    assert dirs[0][1] == dirs[1][1] and dirs[0][1]
    assert seg.gc_floor(dirs[0][0]) == ref_seg.gc_floor(dirs[1][0]) > 0
    assert _files(dirs[0][0]) == _files(dirs[1][0])


# ---------------------------------------------------------------- erasure


def test_protect_store_shards_byte_equal_to_reference(tmp_path):
    store_dir = _filled(tmp_path)
    ref_dir = _twin(store_dir, tmp_path)
    assert er.protect_store(store_dir, **CPU) == ref_er.protect_store(ref_dir)
    assert len(er.shard_file_names(store_dir)) >= 10
    assert _files(store_dir) == _files(ref_dir)
    assert er.shard_file_names(store_dir) == ref_er.shard_file_names(ref_dir)


def _damage_lost_and_corrupt(d):
    sealed = er._segment_names(d)[:-1]
    os.remove(os.path.join(d, sealed[0]))
    with open(os.path.join(d, sealed[1]), "r+b") as f:
        f.seek(17)
        f.write(b"\xde\xad\xbe\xef")


def _damage_shards(lost, drop_segment=True):
    def damage(d):
        name = er._segment_names(d)[0]
        for i in lost:
            os.remove(er.shard_paths(d, name)[i])
        if drop_segment:
            os.remove(os.path.join(d, name))
    return damage


def _damage_corrupt_shard(d):
    name = er._segment_names(d)[0]
    with open(er.shard_paths(d, name)[0], "r+b") as f:
        f.seek(er._HEADER.size + 3)
        f.write(b"\xff\xff")
    os.remove(os.path.join(d, name))


def _damage_mixed_generations(d):
    """Two shards of a healthy segment's set from another generation: no
    consistent set survives, so it is re-encoded fresh from the segment."""
    names = er._segment_names(d)
    for i in (0, 3):
        shutil.copy(er.shard_paths(d, names[1])[i],
                    er.shard_paths(d, names[0])[i])


DAMAGE = {
    "lost+corrupt-segments": _damage_lost_and_corrupt,
    "3-shards-lost": _damage_shards((0, 1, 2)),
    "corrupt-shard": _damage_corrupt_shard,
    "parity-lost-only": _damage_shards((3, 4), drop_segment=False),
    "mixed-generations": _damage_mixed_generations,
    **{f"lost-{a}{b}": _damage_shards((a, b))
       for a, b in itertools.combinations(range(5), 2)},
}


@pytest.mark.parametrize("case", sorted(DAMAGE))
def test_repair_store_matches_reference(tmp_path, case):
    store_dir = _filled(tmp_path, rounds=24, segment_bytes=1024)
    er.protect_store(store_dir, **CPU)
    before = list(seg.scan_store(store_dir, use_native=False))
    ref_dir = _twin(store_dir, tmp_path)
    DAMAGE[case](store_dir)
    DAMAGE[case](ref_dir)
    got = er.repair_store(store_dir, **CPU)
    assert got == ref_er.repair_store(ref_dir)
    assert _files(store_dir) == _files(ref_dir)
    if case != "3-shards-lost":
        assert list(seg.scan_store(store_dir, use_native=False)) == before


def test_three_shard_losses_fail_cleanly(tmp_path):
    store_dir = _filled(tmp_path, rounds=12, segment_bytes=1024)
    er.protect_store(store_dir, **CPU)
    name = er._segment_names(store_dir)[0]
    for p in er.shard_paths(store_dir, name)[:3]:
        os.remove(p)
    os.remove(os.path.join(store_dir, name))
    with pytest.raises(er.ShardError):
        er.reconstruct_segment(store_dir, name, **CPU)


def test_empty_segment_and_partial_set_like_reference(tmp_path):
    for mod, kw, name in ((er, CPU, "port"), (ref_er, {}, "ref")):
        d = str(tmp_path / name)
        os.makedirs(d)
        open(os.path.join(d, "segment-00000000.log"), "wb").close()
        with open(os.path.join(d, "segment-00000001.log"), "wb") as f:
            f.write(b"x" * 64)
        assert mod.protect_store(d, **kw) == []
        assert mod._shard_counts(d) == {}
    store_dir = _filled(tmp_path, name="partial", rounds=12,
                        segment_bytes=1024)
    er.protect_store(store_dir, **CPU)
    name = er._segment_names(store_dir)[0]
    ref_dir = _twin(store_dir, tmp_path)
    for d in (store_dir, ref_dir):
        for p in er.shard_paths(d, name)[1:]:
            os.remove(p)
    assert er.protect_store(store_dir, **CPU) == ref_er.protect_store(ref_dir)
    assert _files(store_dir) == _files(ref_dir)


def test_refill_from_peers_and_index_gaps_like_reference(tmp_path):
    peer = _filled(tmp_path, name="peer", rounds=24, segment_bytes=1024)
    er.protect_store(peer, **CPU)
    results = []
    for mod, kw, name in ((er, CPU, "port"), (ref_er, {}, "ref")):
        local = str(tmp_path / name)
        shutil.copytree(peer, local)
        names = mod._segment_names(local)
        lost = names[1]
        os.remove(os.path.join(local, lost))
        for p in mod.shard_paths(local, lost):
            os.remove(p)
        assert mod.segment_index_gaps(local)
        rs_dir = os.path.join(peer, "rs")
        served = []

        def get(tag, fname, rs_dir=rs_dir, served=served):
            served.append(fname)
            with open(os.path.join(rs_dir, fname), "rb") as f:
                blob = f.read()
            return blob if not fname.endswith("shard0") else blob[:-1]

        def listing(rs_dir=rs_dir):
            return sorted(os.listdir(rs_dir)) + ["../evil.shard0",
                                                 "segment-0000000x.log.shard1"]

        refilled = mod.refill_from_peers(local, [("p", listing)], get)
        repaired = mod.repair_store(local, **kw)
        assert not mod.segment_index_gaps(local)
        results.append((refilled, repaired, served, _files(local)))
    assert results[0] == results[1]
    assert results[0][0] and results[0][1]
    assert [er.valid_shard_name(n) for n in (
        "segment-00000001.log.shard4", "segment-00000001.log.shard5",
        "../x.log.shard0", "segment-0000000a.log.shard1")] == [
        ref_er.valid_shard_name(n) for n in (
            "segment-00000001.log.shard4", "segment-00000001.log.shard5",
            "../x.log.shard0", "segment-0000000a.log.shard1")]


# --------------------------------------------------------------- recovery


def _round_store(directory, store_cls, cfg, **kw):
    """A committed-round record stream with appends, offsets, producer
    entries, a regressing base and a coverage hole, written through the
    store with erasure on (small segments so several seal)."""
    SB = cfg["slot_bytes"]
    rng = np.random.default_rng(7)
    store = store_cls(directory, segment_bytes=1024, use_native=False,
                      erasure=True, **kw)
    ends = [0] * cfg["partitions"]
    for r in range(24):
        recs = []
        for p in range(cfg["partitions"]):
            if rng.random() < 0.3:
                continue
            n = int(rng.integers(1, cfg["max_batch"] + 1))
            adv = -(-n // 8) * 8
            rows = rng.integers(0, 256, size=(adv, SB), dtype=np.uint8)
            rows[:, 4:8] = np.frombuffer(struct.pack("<i", 1 + r // 8),
                                         np.uint8)
            base = ends[p]
            if r == 13 and p == 1:
                base -= 8  # a regressing record: later rows win
            if r == 17 and p == 2:
                base += 16  # a coverage hole
            recs.append((seg.REC_APPEND, p, base, rows.tobytes()))
            ends[p] = base + adv
            if rng.random() < 0.5:
                recs.append((seg.REC_PIDSEQ, p, 1, struct.pack(
                    "<IqIq", 7 + p, r, n, base)))
            if rng.random() < 0.5:
                pairs = [(int(rng.integers(0, 10)), int(rng.integers(0, 999)))
                         for _ in range(3)]
                recs.append((seg.REC_OFFSETS, p, len(pairs), b"".join(
                    struct.pack("<II", s, o) for s, o in pairs)))
        store.append_many(recs)
        store.flush()
    store.close()
    assert store.erasure_errors == []


@pytest.mark.parametrize("damage", ["none", "lost+corrupt"])
def test_recover_image_equals_reference_leaf_for_leaf(tmp_path, damage):
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    _round_store(port_dir, seg.SegmentStore, SMALL, **CPU)
    _round_store(ref_dir, ref_seg.SegmentStore, SMALL)
    assert _files(port_dir) == _files(ref_dir)
    sealed = er._segment_names(port_dir)[:-1]
    assert len(sealed) >= 3 and er._protected_names(port_dir) >= set(sealed)
    if damage != "none":
        _damage_lost_and_corrupt(port_dir)
        _damage_lost_and_corrupt(ref_dir)
    gaps, ref_gaps, pids, ref_pids = {}, {}, {}, {}
    image = recover_image(EngineConfig(**SMALL), port_dir, use_native=False,
                          gaps_out=gaps, pid_tab_out=pids, **CPU)
    want = ref_recover(RefConfig(**SMALL), ref_dir, use_native=False,
                       gaps_out=ref_gaps, pid_tab_out=ref_pids)
    assert image.log_data.device.type == "cpu"
    got = convert.image_to_numpy(image)
    ref_img = convert.image_to_numpy(
        convert.image_from_numpy(want, device="cpu"))
    assert set(got) == set(ref_img) == set(image._fields)
    for leaf in got:
        np.testing.assert_array_equal(got[leaf], ref_img[leaf], err_msg=leaf)
        np.testing.assert_array_equal(got[leaf], np.asarray(getattr(want, leaf)),
                                      err_msg=leaf)
    assert gaps == ref_gaps and gaps  # the hole was found
    assert pids == ref_pids and pids
    assert _files(port_dir) == _files(ref_dir)


def test_recover_image_of_empty_store_is_none(tmp_path):
    d = str(tmp_path / "empty")
    os.makedirs(d)
    assert recover_image(EngineConfig(**SMALL), d, **CPU) is None
    assert ref_recover(RefConfig(**SMALL), d) is None
