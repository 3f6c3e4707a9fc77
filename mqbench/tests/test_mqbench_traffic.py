"""The generator depends on the seed alone."""

import numpy as np

from mqbench import traffic

MIX = {"rate_msgs_per_s": 5000, "batch_min": 1, "batch_max": 256}


def test_open_schedule_is_a_function_of_the_seed():
    a = traffic.open_schedule(MIX, 100, 2**32 + 17, 20.0)
    b = traffic.open_schedule(MIX, 100, 2**32 + 17, 20.0)
    for k in a:
        assert np.array_equal(a[k], b[k])
    c = traffic.open_schedule(MIX, 100, 2**32 + 18, 20.0)
    assert not np.array_equal(a["n"], c["n"])


def test_every_seed_offers_the_same_work():
    a = traffic.open_schedule(MIX, 100, 1, 20.0)
    c = traffic.open_schedule(MIX, 100, 2**33 + 1, 20.0)
    assert np.array_equal(np.sort(a["n"]), np.sort(c["n"]))
    assert abs(a["n"].sum() / 20.0 - 5000) < 100
    assert np.all(np.diff(a["due_s"]) > 0) and a["due_s"][-1] < 20.0
    assert a["n"].min() >= 1 and a["n"].max() <= 256


def test_payloads_round_trip_and_ids():
    pl = traffic.Payloads(2**31 + 5, 1024)
    msgs = pl.make(5 * 10**9, 3, 41, 7, 5)
    ids, due, part, ok = pl.verify(msgs)
    assert ok.all() and (part == 7).all() and (due == 5 * 10**9).all()
    assert np.array_equal(ids, traffic.request_ids(3, 41, 5))
    other = traffic.Payloads(2**31 + 6, 1024)
    assert not other.verify(msgs)[3].any()
