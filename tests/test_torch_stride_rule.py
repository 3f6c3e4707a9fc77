"""The ring-stride aliasing rule, promoted from a bench comment to code.

The reference found, on its own device (PROFILE.md), that a
per-partition ring stride on/near a >= 2^20 power of two makes strided
partition writes alias memory channels, at slots 8192 / SB 128 (stride
2^20 + 32 KiB). EngineConfig warns at construction
(core.config.stride_alias_hazard) instead of relying on whoever reads
bench.py's comments; the port keeps the rule, unmeasured on its card.

Twin of `tests/test_stride_rule.py` on the PyTorch port's
`ripplemq_tpu_torch/core/config.py` (`stride_alias_hazard`,
`ring_stride_bytes`, the construction-time warning), plus one
cross-package test: both packages' verdicts agree over a grid of
shapes and stream counts.
"""

import warnings

import pytest

from ripplemq_tpu_torch.core.config import (
    EngineConfig,
    STRIDE_POW2_FLOOR,
    ring_stride_bytes,
    stride_alias_hazard,
)
from tests.torch_port_modules import admit

admit(__name__)


def test_measured_bad_shape_is_flagged():
    # The EXACT shape the reference measured the penalty at: slots 8192,
    # B 256, SB 128 -> stride (8192+256)*128 = 2^20 + 32 KiB (3.1% off).
    msg = stride_alias_hazard(8192, 256, 128)
    assert msg is not None
    assert "2^20" in msg


def test_exact_power_of_two_is_flagged():
    # slots+B landing the stride EXACTLY on 2^20.
    assert ring_stride_bytes(8064, 128, 128) == 1 << 20
    assert stride_alias_hazard(8064, 128, 128) is not None


def test_headline_shape_is_healthy():
    # The shipped headline ring: slots 12352, B 256, SB 128 — the shape
    # the bench uses BECAUSE it sits far from the hazard band.
    assert stride_alias_hazard(12352, 256, 128) is None


def test_small_strides_never_flag():
    # Below the 2^20 floor nothing warns (2^15-ish test configs would
    # otherwise drown in false positives).
    assert stride_alias_hazard(64, 8, 32) is None
    assert stride_alias_hazard(2048, 32, 128) is None


def test_near_higher_power_flagged_too():
    # The band tracks whatever power of two the stride is nearest,
    # not just 2^20: stride ~2^21 aliases the same way.
    slots = (1 << 21) // 128 - 256 + 8  # stride = 2^21 + 1 KiB
    assert stride_alias_hazard(slots, 256, 128) is not None


def test_engine_config_warns_on_hazardous_shape():
    with pytest.warns(UserWarning, match="write-rate penalty"):
        EngineConfig(partitions=1024, replicas=3, slots=8192,
                     slot_bytes=128, max_batch=256)


def test_engine_config_silent_on_healthy_shape():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        EngineConfig(partitions=1024, replicas=3, slots=12352,
                     slot_bytes=128, max_batch=256)


def test_small_fanout_does_not_warn():
    # The shipped P=8 example sits near 2^20 on purpose (its sizing
    # note: too few concurrent strided streams to alias measurably) —
    # the WARNING gates on fan-out, though the helper still reports.
    assert stride_alias_hazard(4096, 32, 256) is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        EngineConfig(partitions=8, replicas=3, slots=4096, slot_bytes=256,
                     max_batch=32)


def test_floor_constant_is_a_megabyte():
    # The rule's floor is load-bearing for the tests above; pin it.
    assert STRIDE_POW2_FLOOR == 1 << 20


# --------------------------------------------------- per-device (sharded)


def test_sharded_global_hazard_local_clean():
    # A P=1024 config at the measured-bad stride flags when one device
    # holds all 1024 rings — but sharded 32 ways each device holds 32
    # concurrent streams, too few to alias: the per-device verdict must
    # be clean (warning on the global shape would flag a layout no
    # device actually holds).
    assert stride_alias_hazard(8192, 256, 128, streams=1024) is not None
    assert stride_alias_hazard(8192, 256, 128, streams=32) is None


def test_local_hazard_global_clean():
    # The inverse miss: the old gate priced cfg.partitions alone, but
    # the LOCAL binding keeps every replica's rings on one chip. P=32
    # R=3 puts 96 strided streams on the device — above the aliasing
    # threshold although the partition count alone sits below it.
    assert stride_alias_hazard(8192, 256, 128, streams=96) is not None
    with pytest.warns(UserWarning, match="write-rate penalty"):
        EngineConfig(partitions=32, replicas=3, slots=8192,
                     slot_bytes=128, max_batch=256)


def test_streams_gate_boundary():
    # The gate is inclusive at STRIDE_WARN_MIN_PARTITIONS (the measured
    # finding was well above it; the boundary itself must be stable).
    bad = (8192, 256, 128)
    assert stride_alias_hazard(*bad, streams=64) is not None
    assert stride_alias_hazard(*bad, streams=63) is None
    # streams only gates — it never turns a healthy stride hazardous.
    assert stride_alias_hazard(12352, 256, 128, streams=4096) is None


def test_verdicts_equal_the_reference_over_a_grid():
    """The same rule in both packages: every verdict over slots around
    the 2^20 and 2^21 bands, three batch widths, two row widths and
    stream counts across the gate. A flagged verdict states the same
    stride and band; only the reason differs, since the port's names no
    TPU measurement as its own."""
    from ripplemq_tpu.core import config as ref

    seen = 0
    for sb in (128, 256):
        for b in (32, 128, 256):
            for target in (1 << 20, 1 << 21):
                centre = target // sb - b
                for slots in range(centre - 600, centre + 601, 40):
                    for streams in (None, 32, 63, 64, 96, 4096):
                        kw = {} if streams is None else {"streams": streams}
                        got = stride_alias_hazard(slots, b, sb, **kw)
                        want = ref.stride_alias_hazard(slots, b, sb, **kw)
                        assert (got is None) == (want is None), (
                            slots, b, sb, streams)
                        if got is not None:
                            assert got.split(";")[0] == want.split(";")[0]
                            seen += 1
                    assert ring_stride_bytes(slots, b, sb) == \
                        ref.ring_stride_bytes(slots, b, sb)
    assert seen > 0
    assert STRIDE_POW2_FLOOR == ref.STRIDE_POW2_FLOOR
