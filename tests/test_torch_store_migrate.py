"""Store frame-CRC migration (`python -m
ripplemq_tpu_torch.profiles.store_migrate`): a payload-only-CRC store
rewrites to header-covered framing, verified by verify_store — the
upgrade path the deliberately unversioned format break needs.

Twin of `tests/test_store_migrate.py` on the PyTorch port (its four
tests against the port's tool, the last one booting the port's plane
image on the CPU), plus one cross-package test: the same legacy store
migrated by the reference's tool and by the port's gives byte-identical
segment files and the same report.
"""

from __future__ import annotations

import os
import struct
import zlib

import pytest

from ripplemq_tpu_torch.profiles.store_migrate import (
    MigrationError,
    main,
    migrate_store,
)
from ripplemq_tpu_torch.storage.segment import (
    REC_APPEND,
    REC_OFFSETS,
    CorruptStoreError,
    scan_store,
    verify_store,
)
from tests.torch_port_modules import admit

admit(__name__)

_HEADER_PREFIX = struct.Struct("<IBIII")
_CRC = struct.Struct("<I")
_MAGIC = 0x474C5152


def _legacy_frame(rec_type: int, slot: int, base: int,
                  payload: bytes) -> bytes:
    """A frame exactly as the payload-only writer framed it: crc over the
    PAYLOAD only."""
    hdr = _HEADER_PREFIX.pack(_MAGIC, rec_type, slot, base, len(payload))
    return hdr + _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _write_legacy_store(directory: str,
                        records: list[tuple[int, int, int, bytes]],
                        per_segment: int = 3) -> None:
    os.makedirs(directory, exist_ok=True)
    seg = -1
    f = None
    for i, rec in enumerate(records):
        if i % per_segment == 0:
            if f is not None:
                f.close()
            seg += 1
            f = open(os.path.join(directory, f"segment-{seg:08d}.log"),
                     "wb")
        f.write(_legacy_frame(*rec))
    if f is not None:
        f.close()


RECORDS = [
    (REC_APPEND, 0, 0, b"\x00" * 64),
    (REC_APPEND, 1, 0, b"\x01" * 64),
    (REC_OFFSETS, 0, 1, struct.pack("<II", 2, 8)),
    (REC_APPEND, 0, 2, b"\x02" * 64),
    (REC_APPEND, 1, 2, b"\x03" * 128),
]


def test_legacy_store_fails_modern_walk_then_migrates(tmp_path):
    d = str(tmp_path / "segments")
    _write_legacy_store(d, RECORDS)
    # Failing-before: the modern health walk refuses legacy frames.
    with pytest.raises(CorruptStoreError):
        verify_store(d)
    stats = migrate_store(d)
    assert stats["migrated"] and stats["legacy_frames"] == len(RECORDS)
    # Passing-after: the modern walk accepts the rewrite…
    assert verify_store(d) == len(RECORDS)
    # …the records round-trip byte-identically…
    assert list(scan_store(d, use_native=False)) == RECORDS
    # …segment boundaries survive, and the original bytes are kept.
    assert sorted(x for x in os.listdir(d) if x.endswith(".log")) == [
        "segment-00000000.log", "segment-00000001.log"
    ]
    assert stats["backup"] and os.path.isdir(stats["backup"])


def test_modern_store_is_a_noop_and_mixed_frames_migrate(tmp_path):
    from ripplemq_tpu_torch.storage.segment import SegmentStore

    d = str(tmp_path / "segments")
    store = SegmentStore(d, use_native=False)
    for rec in RECORDS:
        store.append(*rec)
    store.close()
    stats = migrate_store(d)
    assert not stats["migrated"] and stats["modern_frames"] == len(RECORDS)
    assert stats["legacy_frames"] == 0
    # Mixed store (a deployment that crashed mid-upgrade and appended
    # modern frames after legacy ones): everything lands header-covered.
    with open(os.path.join(d, sorted(
        x for x in os.listdir(d) if x.endswith(".log")
    )[-1]), "ab") as f:
        f.write(_legacy_frame(REC_APPEND, 2, 0, b"\x04" * 64))
    stats = migrate_store(d)
    assert stats["migrated"] and stats["legacy_frames"] == 1
    assert verify_store(d) == len(RECORDS) + 1


def test_torn_tail_dropped_but_midfile_rot_refused(tmp_path):
    d = str(tmp_path / "segments")
    _write_legacy_store(d, RECORDS, per_segment=10)  # one segment
    path = os.path.join(d, "segment-00000000.log")
    with open(path, "ab") as f:
        f.write(b"\x13\x37torn")  # torn tail garbage
    stats = migrate_store(d)
    assert stats["migrated"] and stats["legacy_frames"] == len(RECORDS)
    assert list(scan_store(d, use_native=False)) == RECORDS  # tail gone
    # Mid-file rot (valid frames after the damage) must REFUSE — the
    # migration is for format conversion, not corruption laundering.
    d2 = str(tmp_path / "rot")
    _write_legacy_store(d2, RECORDS, per_segment=10)
    p2 = os.path.join(d2, "segment-00000000.log")
    blob = bytearray(open(p2, "rb").read())
    blob[40] ^= 0xFF  # flip a byte inside the first record's payload
    open(p2, "wb").write(bytes(blob))
    with pytest.raises(MigrationError):
        migrate_store(d2)
    # Untouched on failure.
    assert open(p2, "rb").read() == bytes(blob)


def test_migrated_store_boots_a_dataplane(tmp_path):
    """End to end: a legacy store holding REAL round records (engine-
    shaped rows) migrates, then recovers a plane image via recover_image
    on the CPU and installs it into a port DataPlane — the upgrade
    sequence an operator runs."""
    import numpy as np

    from ripplemq_tpu_torch.broker.dataplane import recover_image
    from tests.torch_helpers import port_cfg, port_dp

    cfg = port_cfg(partitions=2, replicas=3)
    rows = np.zeros((8, cfg.slot_bytes), np.uint8)
    rows[:, 0] = 4  # row length header: 4 payload bytes
    rows[:, 8:12] = 7
    d = str(tmp_path / "segments")
    _write_legacy_store(d, [
        (REC_APPEND, 0, 0, rows.tobytes()),
        (REC_OFFSETS, 1, 1, struct.pack("<II", 0, 8)),
    ])
    migrate_store(d)
    image = recover_image(cfg, d, use_native=False, device="cpu")
    assert int(image.log_end[0]) == 8
    assert int(image.offsets[1, 0]) == 8
    dp = port_dp(cfg)
    try:
        dp.install(image)
        dp.start()
        assert dp.log_end(0) == 8
        assert dp.read_offset(1, 0) == 8
    finally:
        dp.stop()


def _cross_store() -> list:
    """A legacy store with every case the walk distinguishes: several
    segments, record types, payload sizes (one empty), and a torn tail
    in the last segment."""
    import numpy as np

    rng = np.random.default_rng(11)
    recs = []
    for i in range(23):
        n = int(rng.integers(0, 300)) if i != 5 else 0
        recs.append((int(rng.choice([REC_APPEND, REC_OFFSETS])),
                     int(rng.integers(0, 8)), int(rng.integers(0, 1 << 20)),
                     rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
    return recs


@pytest.mark.parametrize("dry_run", [False, True], ids=["migrate", "dry-run"])
def test_same_files_and_report_as_the_reference_tool(tmp_path, dry_run):
    """The reference's `profiles.store_migrate.migrate_store` and the
    port's, each on its own copy of one legacy store: the same report
    (up to the directory names) and byte-identical files after it."""
    from profiles.store_migrate import migrate_store as ref_migrate

    recs = _cross_store()
    stats, files = {}, {}
    for side, fn in (("ref", ref_migrate), ("port", migrate_store)):
        d = str(tmp_path / side / "segments")
        _write_legacy_store(d, recs, per_segment=7)
        with open(os.path.join(d, "segment-00000003.log"), "ab") as f:
            f.write(b"\x52\x51torn-tail")
        with open(os.path.join(d, "gc_floor"), "w") as f:
            f.write("0\n")
        st = fn(d, dry_run=dry_run)
        stats[side] = {k: (os.path.basename(v) if k in ("directory", "backup")
                           and v else v) for k, v in st.items()}
        files[side] = {
            os.path.relpath(os.path.join(root, x), str(tmp_path / side)):
            open(os.path.join(root, x), "rb").read()
            for root, _, names in os.walk(str(tmp_path / side))
            for x in names}
    assert stats["port"] == stats["ref"]
    assert stats["port"]["legacy_frames"] == len(recs)
    assert stats["port"]["migrated"] is (not dry_run)
    assert files["port"].keys() == files["ref"].keys()
    for name in files["ref"]:
        assert files["port"][name] == files["ref"][name], name
    if not dry_run:
        assert list(scan_store(str(tmp_path / "port" / "segments"),
                               use_native=False)) == recs


def test_cli_reports_json_and_needs_no_device(tmp_path, monkeypatch, capsys):
    """The CLI reads and writes files only: with no GPU it still runs,
    prints one JSON report and exits 0 (1 on refused rot)."""
    import json

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "segments")
    _write_legacy_store(d, RECORDS)
    assert main([d, "--dry-run"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["legacy_frames"] == len(RECORDS)
    assert not out["migrated"]
    assert main([d]) == 0
    assert json.loads(capsys.readouterr().out)["migrated"]
    d2 = str(tmp_path / "rot")
    _write_legacy_store(d2, RECORDS, per_segment=10)
    p2 = os.path.join(d2, "segment-00000000.log")
    blob = bytearray(open(p2, "rb").read())
    blob[40] ^= 0xFF
    open(p2, "wb").write(bytes(blob))
    assert main([d2]) == 1
    assert not json.loads(capsys.readouterr().out)["ok"]
