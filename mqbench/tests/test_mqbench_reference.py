"""The plain reference flags every way a log can go wrong."""

import numpy as np
import pytest

from mqbench import reference
from mqbench.traffic import request_ids

ACKS = [(0, 0, 3, 0, 4), (1, 0, 3, 8, 2), (0, 1, 5, 0, 3)]


def logs():
    got, overlaps = reference.expected_logs(ACKS)
    assert overlaps == 0
    return got


def run(deliveries, standbys=None, failed=0, faults=None):
    logs_ = logs()
    if standbys is None:
        standbys = [dict(logs_), dict(logs_)]
    return reference.check_run(ACKS, failed, deliveries, faults or {},
                               standbys, min_insync=2)


def test_exact_run_is_clean():
    assert not any(run(logs()).values())


def mutate(kind):
    d = logs()
    p3 = d[3].copy()
    if kind == "dropped":
        d[3] = np.delete(p3, 2)
    elif kind == "duplicated":
        d[3] = np.insert(p3, 3, p3[1])
    elif kind == "reordered":
        p3[[1, 2]] = p3[[2, 1]]
        d[3] = p3
    elif kind == "never_acked":
        d[3] = np.append(p3, request_ids(7, 9, 1))
    return d


@pytest.mark.parametrize("kind,key", [("dropped", "missing"),
                                      ("duplicated", "duplicated"),
                                      ("reordered", "reordered"),
                                      ("never_acked", "never_acked")])
def test_flags(kind, key):
    out = run(mutate(kind))
    assert out[key] > 0, out


def test_corrupt_bytes_flagged_by_payload_check():
    from mqbench.traffic import Payloads

    pl = Payloads(2**40 + 3, 100)
    msgs = pl.make(10**12, 0, 0, 3, 4)
    bad = bytearray(msgs[1])
    bad[60] ^= 0x20
    msgs[1] = bytes(bad)
    ids, _, part, ok = pl.verify(msgs)
    assert ok.tolist() == [True, False, True, True]
    out = run(logs(), faults={"corrupt": int((~ok).sum())})
    assert out["corrupt"] == 1


def test_header_flip_is_corrupt():
    from mqbench.traffic import Payloads

    pl = Payloads(5, 1024)
    m = bytearray(pl.make(123, 1, 2, 3, 1)[0])
    m[3] ^= 1  # the due time
    assert not pl.verify([bytes(m)])[3][0]


def test_under_replicated():
    d = logs()
    out = run(d, standbys=[{}, {}])
    assert out["under_replicated"] == sum(len(v) for v in d.values())
    one = dict(d)
    assert run(d, standbys=[one, {}])["under_replicated"] == 0


def test_overlapping_acks():
    _, overlaps = reference.expected_logs(ACKS + [(2, 0, 3, 2, 4)])
    assert overlaps == 1


def _frame(rec, slot, base, payload):
    import struct
    import zlib

    from mqbench import store

    head = struct.pack("<IBIII", store.MAGIC, rec, slot, base, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(head))
    return head + struct.pack("<I", crc) + payload


def test_store_frames_read_back_and_bad_ones_count(tmp_path):
    from mqbench import store

    good = _frame(1, 4, 0, b"a" * 16) + _frame(2, 0, 0, b"x") \
        + _frame(1, 4, 1, b"b" * 16) + _frame(1, 4, 0, b"c" * 16)
    (tmp_path / "segment-00000000.log").write_bytes(good)
    by_slot, bad = store.scan_appends(str(tmp_path))
    assert bad == 0
    assert by_slot == {4: {0: b"c" * 16, 1: b"b" * 16}}
    flipped = bytearray(_frame(1, 5, 0, b"d" * 16))
    flipped[9] ^= 1  # the base, under the crc
    (tmp_path / "segment-00000001.log").write_bytes(bytes(flipped))
    by_slot, bad = store.scan_appends(str(tmp_path))
    assert bad == 1 and 5 not in by_slot
