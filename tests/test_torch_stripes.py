"""Stripe codec and recovery: the port's `stripes/` against the JAX reference.

The same records go through the reference's `encode_group` (its XLA
fallback on the CPU, `platform="cpu"`) and the port's (`device="cpu"`,
the plain torch version); frames must be byte-equal, parses equal, and
every reconstruct and every rebuild scenario of `tests/test_stripes.py`
must give the same records or the same exception. Exact throughout.
"""

from __future__ import annotations

import itertools

import pytest

from ripplemq_tpu.storage.segment import REC_STRIPE as REF_REC_STRIPE
from ripplemq_tpu.stripes import codec as ref
from ripplemq_tpu.stripes import recovery as ref_rec
from ripplemq_tpu_torch.storage.segment import REC_STRIPE
from ripplemq_tpu_torch.stripes import codec as port
from ripplemq_tpu_torch.stripes import recovery as port_rec
from tests.torch_port_modules import admit

admit(__name__)

N = port.RS_K + port.RS_M

# append rows, a pid entry, an offset batch: the shapes the settle path
# replicates (tests/test_stripes.py RECORDS)
RECORDS = [
    (1, 0, 0, b"row-" * 32),
    (4, 0, 1, b"\x01\x00\x00\x00" + b"\x00" * 20),
    (1, 1, 8, bytes(range(256)) * 3),
    (2, 1, 2, b"\x02\x00\x00\x00\x09\x00\x00\x00"),
]
GROUPS = [
    (1, 100, RECORDS),
    (1, 101, [(1, 0, 8, b"second-round" * 10)]),
    (1, 102, [(1, 1, 16, b"third" * 50), (2, 1, 1, b"\x00" * 8)]),
]


def _both(records, epoch, gsn, **kw):
    return (ref.encode_group(records, epoch, gsn, platform="cpu", **kw),
            port.encode_group(records, epoch, gsn, device="cpu", **kw))


@pytest.mark.parametrize("records,epoch,gsn,kw", [
    (RECORDS, 1, 5, {}),
    ([], 2, 0, {}),
    ([], 1, 11, dict(tombstone=True, settled_floor=10)),
    ([(1, 0, 0, b"prefix-rows" * 8)], 3, 90, dict(catchup=True)),
    ([(1, 0, 8, b"live" * 999)], 7, 2 ** 40, dict(settled_floor=2 ** 40 - 1)),
    ([(1, 0, i, bytes([i % 251]) * 1024) for i in range(40)], 1, 3,
     dict(settled_floor=2, catchup=True, tombstone=True)),
], ids=["records", "empty", "tombstone", "catchup", "wide-gsn", "all-flags"])
def test_frames_byte_equal_to_reference(records, epoch, gsn, kw):
    want, got = _both(records, epoch, gsn, **kw)
    assert got == want
    for f in got:
        assert port.parse_frame(f) == ref.parse_frame(f)


def test_serialize_roundtrip_equals_reference():
    blob = port.serialize_records(RECORDS)
    assert blob == ref.serialize_records(RECORDS)
    assert port.deserialize_records(blob) == ref.deserialize_records(blob)
    for cut in (0, 3, 6, 20, len(blob) - 1):
        with pytest.raises(ValueError):
            port.deserialize_records(blob[:cut])
        with pytest.raises(ValueError):
            ref.deserialize_records(blob[:cut])


def test_damaged_frames_parse_as_missing_in_both():
    frames = port.encode_group(RECORDS, 1, 5, device="cpu")
    for pos in list(range(0, len(frames[0]), 3)) + [len(frames[0]) - 1]:
        b = bytearray(frames[0])
        b[pos] ^= 0xFF
        assert port.parse_frame(bytes(b)) is None, pos
        assert ref.parse_frame(bytes(b)) is None, pos
    for damaged in (frames[1][:10], frames[1][:-1], frames[1] + b"x", b""):
        assert port.parse_frame(damaged) is None
        assert ref.parse_frame(damaged) is None


def test_every_k_subset_reconstructs_and_below_k_refuses():
    frames = port.encode_group(RECORDS, 1, 5, device="cpu")
    parsed = {i: port.parse_frame(f) for i, f in enumerate(frames)}
    ref_parsed = {i: ref.parse_frame(f) for i, f in enumerate(frames)}
    for subset in itertools.combinations(range(N), port.RS_K):
        got = port.reconstruct_group({i: parsed[i] for i in subset},
                                     device="cpu")
        want = ref.reconstruct_group({i: ref_parsed[i] for i in subset},
                                     platform="cpu")
        assert got == want == RECORDS, subset
    for r in range(port.RS_K):
        for subset in itertools.combinations(range(N), r):
            with pytest.raises(port.StripeShortError):
                port.reconstruct_group({i: parsed[i] for i in subset})


def test_mixed_generations_and_bad_blob_crc_refuse_like_reference():
    a = port.encode_group(RECORDS, 1, 5, device="cpu")
    b = port.encode_group(RECORDS[:2], 1, 5, device="cpu")
    mixed = {0: port.parse_frame(a[0]), 1: port.parse_frame(b[1]),
             3: port.parse_frame(a[3])}
    with pytest.raises(ValueError, match="mixed"):
        port.reconstruct_group(mixed, device="cpu")
    ref_mixed = {0: ref.parse_frame(a[0]), 1: ref.parse_frame(b[1]),
                 3: ref.parse_frame(a[3])}
    with pytest.raises(ValueError, match="mixed"):
        ref.reconstruct_group(ref_mixed, platform="cpu")
    # A frame whose blob CRC lies (valid frame CRC over a wrong blob crc)
    # reconstructs bytes that fail the recorded CRC.
    bad = port.parse_frame(a[0])._replace(blob_crc=1)
    frames = {0: bad, 1: port.parse_frame(a[1])._replace(blob_crc=1),
              2: port.parse_frame(a[2])._replace(blob_crc=1)}
    with pytest.raises(ValueError, match="CRC"):
        port.reconstruct_group(frames, device="cpu")


def test_shard_class_equals_reference_over_1_to_200000():
    assert port._shard_class(0) == ref._shard_class(0)
    assert [port._shard_class(n) for n in range(1, 200_001)] == [
        ref._shard_class(n) for n in range(1, 200_001)]


@pytest.mark.parametrize("standbys", [(), (7,), (9, 4), (4, 9), (3, 1, 2, 0),
                                      (1, 2, 3, 4), (5, 5, 6), range(10)])
def test_stripe_assignment_equals_reference(standbys):
    assert port.stripe_assignment(standbys) == ref.stripe_assignment(standbys)


# ---------------------------------------------------------------- recovery


def _holder_stores(codec, groups, rec_stripe, members=(10, 11, 12, 13, 14),
                   **kw):
    """tests/test_stripes.py's distribution: each group's stripes per the
    replicated assignment, frames carrying the predecessor's gsn as the
    settled floor."""
    held = codec.stripe_assignment(members)
    stores = {b: [] for b in members}
    prev = 0
    for epoch, gsn, records in groups:
        frames = codec.encode_group(records, epoch, gsn, settled_floor=prev,
                                    **kw)
        prev = gsn
        for i, f in enumerate(frames):
            stores[held[i]].append((rec_stripe, i, gsn & 0x7FFFFFFF, f))
    return stores


def _fetcher(records):
    def fetch(after):
        return [p for _, _, _, p in records], None
    return fetch


def _rebuild_both(local, peers=(), **kw):
    """(port result or exception type, reference result or exception type)."""
    out = []
    for mod, dev in ((port_rec, dict(device="cpu")),
                     (ref_rec, dict(platform="cpu"))):
        try:
            out.append(mod.rebuild_records(
                iter(local), [(t, f) for t, f in peers], **kw, **dev))
        except Exception as e:  # compared by type below
            out.append(type(e).__name__)
    return out


def test_stores_and_rebuild_from_any_k_holders_equal_reference():
    stores = _holder_stores(port, GROUPS, REC_STRIPE, device="cpu")
    assert stores == _holder_stores(ref, GROUPS, REF_REC_STRIPE,
                                    platform="cpu")
    want = [r for _, _, recs in GROUPS for r in recs]
    members = sorted(stores)
    for subset in itertools.combinations(members, port.RS_K):
        local, *peers = subset
        got, ref_got = _rebuild_both(
            stores[local], [(f"peer{b}", _fetcher(stores[b])) for b in peers])
        assert got == ref_got == want, subset
    for subset in itertools.combinations(members, port.RS_K - 1):
        local, *peers = subset
        got, ref_got = _rebuild_both(
            stores[local], [(f"peer{b}", _fetcher(stores[b])) for b in peers])
        assert got == ref_got == "StripeDataLossError", subset

    def down(after):
        raise ConnectionError("down")

    assert _rebuild_both(stores[members[0]], [("peer", down)]) == [
        "StripeRecoveryError"] * 2
    assert _rebuild_both(stores[members[0]], peers_incomplete=True) == [
        "StripeRecoveryError"] * 2


def test_torn_tail_drops_but_midstream_loss_refuses_like_reference():
    stores = _holder_stores(port, GROUPS, REC_STRIPE, device="cpu")
    merged = [r for b in sorted(stores) for r in stores[b]]
    tail_gsn = GROUPS[-1][1] & 0x7FFFFFFF
    mid_gsn = GROUPS[1][1] & 0x7FFFFFFF
    tail_short = [r for r in merged if r[2] != tail_gsn or r[1] in (0, 1)]
    got, ref_got = _rebuild_both(tail_short)
    assert got == ref_got == [r for _, _, recs in GROUPS[:-1] for r in recs]
    mid_short = [r for r in merged if r[2] != mid_gsn or r[1] in (0, 1)]
    assert _rebuild_both(mid_short) == ["StripeDataLossError"] * 2


def test_tombstoned_group_drops_like_reference():
    ok1 = [(1, 0, 0, b"settled-one" * 4)]
    nacked = [(1, 0, 8, b"nacked" * 10)]
    ok2 = [(1, 0, 8, b"settled-two" * 4)]
    enc = lambda *a, **k: port.encode_group(*a, device="cpu", **k)  # noqa: E731
    recs = [(REC_STRIPE, i, 10, f) for i, f in enumerate(enc(ok1, 1, 10))]
    recs.append((REC_STRIPE, 0, 11, enc(nacked, 1, 11, settled_floor=10)[0]))
    tomb = enc([], 1, 11, tombstone=True, settled_floor=10)[0]
    recs.append((REC_STRIPE, 0, 11, tomb))
    recs += [(REC_STRIPE, i, 12, f)
             for i, f in enumerate(enc(ok2, 1, 12, settled_floor=11))]
    got, ref_got = _rebuild_both(recs)
    assert got == ref_got == ok1 + ok2
    no_tomb = [r for r in recs if r[3] != tomb]
    assert _rebuild_both(no_tomb) == ["StripeDataLossError"] * 2


def test_catchup_groups_replay_first_like_reference():
    live = [(1, 0, 8, b"live-rows" * 4)]
    prefix = [(1, 0, 0, b"prefix-rows" * 8)]
    recs = [(REC_STRIPE, i, 50, f)
            for i, f in enumerate(port.encode_group(live, 3, 50,
                                                    device="cpu"))]
    recs += [(REC_STRIPE, i, 90, f)
             for i, f in enumerate(port.encode_group(prefix, 3, 90,
                                                     catchup=True,
                                                     device="cpu"))]
    # non-stripe records pass through first, in scan order
    plain = [(1, 2, 0, b"own-prefix" * 3)]
    got, ref_got = _rebuild_both(plain + recs)
    assert got == ref_got == plain + prefix + live


def test_peer_merge_adopts_only_valid_new_frames_like_reference():
    frames = port.encode_group(RECORDS, 1, 5, device="cpu")
    rotted = bytearray(frames[2])
    rotted[-1] ^= 1
    raw = [frames[0], bytes(rotted), frames[0], frames[4]]
    groups, ref_groups = {}, {}
    assert (port_rec.merge_peer_frames(groups, raw)
            == ref_rec.merge_peer_frames(ref_groups, raw) == 2)
    assert {k: sorted(v) for k, v in groups.items()} == {
        k: sorted(v) for k, v in ref_groups.items()}
