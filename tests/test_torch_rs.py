"""GF(2⁸) Reed–Solomon: the port's `ops/rs.py` against the JAX reference.

The port's `gf_matmul` runs its plain PyTorch version on the CPU (the
CUDA kernel is held against that same plain version on the card by
`chip_smoke.py`). Here the same numpy shards go through the reference's
Pallas kernel in interpret mode (as `tests/test_rs.py` runs it), its
numpy table reference `gf_matmul_ref`, and the port. Every value is a
byte, so the tolerance is exact equality.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from ripplemq_tpu.ops import rs as ref
from ripplemq_tpu_torch.ops import rs as port
from tests.torch_port_modules import admit

admit(__name__)

# The three matrix shapes the repo uses: the 2x3 encode generator, a 3x3
# reconstruct-like matrix holding zeros, and a 3x2 identity-plus-zero-row.
MATRICES = {
    "encode_2x3": ref.generator_matrix(3, 2),
    "zeros_3x3": ((0, 5, 7), (1, 0, 0), (9, 200, 0)),
    "ident_3x2": ((1, 0), (0, 1), (0, 0)),
}


def test_field_tables_and_matrices_equal_reference():
    assert np.array_equal(port._EXP, ref._EXP)
    assert np.array_equal(port._LOG, ref._LOG)
    for a in range(256):
        for b in range(0, 256, 7):
            assert port.gf_mul(a, b) == ref.gf_mul(a, b)
        if a:
            assert port.gf_inv(a) == ref.gf_inv(a)
    with pytest.raises(ZeroDivisionError):
        port.gf_inv(0)
    for k, m in [(3, 2), (2, 1), (4, 2)]:
        assert port.generator_matrix(k, m) == ref.generator_matrix(k, m)
        assert port.extended_matrix(k, m) == ref.extended_matrix(k, m)


@pytest.mark.parametrize("rows", list(itertools.combinations(range(5), 3)),
                         ids=lambda r: "".join(map(str, r)))
def test_gf_invert_patterns_equal_reference(rows):
    ext = ref.extended_matrix(3, 2)
    sub = [ext[r] for r in rows]
    assert port.gf_invert(sub) == ref.gf_invert(sub)


def test_gf_invert_rejects_singular():
    with pytest.raises(ValueError):
        port.gf_invert([(1, 2), (1, 2)])


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("n", [0, 1, 7, 128, 1000, 4096, 5000])
def test_matmul_equals_pallas_interpret_and_table_ref(n, name):
    coeffs = MATRICES[name]
    rng = np.random.default_rng(n + 17 * len(name))
    shards = rng.integers(0, 256, size=(len(coeffs[0]), n), dtype=np.uint8)
    want = ref.gf_matmul_ref(coeffs, shards)
    pal = np.asarray(ref.gf_matmul(coeffs, shards, use_pallas=False,
                                   interpret=True))
    got = port.gf_matmul(coeffs, shards, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == (len(coeffs), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pal, want)


def test_cpu_tensor_takes_the_plain_path_without_device():
    rng = np.random.default_rng(9)
    shards = rng.integers(0, 256, size=(3, 300), dtype=np.uint8)
    coeffs = MATRICES["encode_2x3"]
    before = port.LAUNCHES["gf_matmul"]
    got = port.gf_matmul(coeffs, torch.from_numpy(shards))
    assert port.LAUNCHES["gf_matmul"] == before
    np.testing.assert_array_equal(got.numpy(),
                                  ref.gf_matmul_ref(coeffs, shards))


def test_largest_supported_matrix_matches_table_ref():
    """M, K up to 16: the kernel tiles such a matrix into 4 x 4 launches;
    the plain version takes it whole."""
    rng = np.random.default_rng(16)
    coeffs = tuple(tuple(int(c) for c in row)
                   for row in rng.integers(0, 256, size=(16, 16)))
    shards = rng.integers(0, 256, size=(16, 333), dtype=np.uint8)
    np.testing.assert_array_equal(
        port.gf_matmul(coeffs, shards, device="cpu").numpy(),
        ref.gf_matmul_ref(coeffs, shards))


def test_kernel_products_are_the_field_products():
    """The kernel's launch argument: c * 2^b in all four byte lanes."""
    coeffs = MATRICES["zeros_3x3"]
    v = port._products(coeffs)
    assert v.shape == (3, 3, 8) and v.dtype == np.uint32
    for i, row in enumerate(coeffs):
        for j, c in enumerate(row):
            for b in range(8):
                lane = ref.gf_mul(c, 1 << b)
                assert int(v[i, j, b]) == lane * 0x01010101


def test_all_two_loss_reconstructs_equal_reference():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(3, 999), dtype=np.uint8)
    parity = port.rs_encode(data, device="cpu").numpy()
    np.testing.assert_array_equal(
        parity, np.asarray(ref.rs_encode(data, use_pallas=False)))
    shards = np.concatenate([data, parity], axis=0)
    for lost in itertools.combinations(range(5), 2):
        present = {i: shards[i] for i in range(5) if i not in lost}
        got = port.rs_reconstruct(present, device="cpu").numpy()
        want = np.asarray(ref.rs_reconstruct(present, use_pallas=False))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data)
        # tensors in, the same bytes out
        tens = {i: torch.from_numpy(v) for i, v in present.items()}
        np.testing.assert_array_equal(port.rs_reconstruct(tens).numpy(), data)


def test_same_value_errors_as_reference():
    with pytest.raises(ValueError):
        ref.gf_matmul(((1, 2),), np.zeros((3, 8), np.uint8))
    with pytest.raises(ValueError):
        port.gf_matmul(((1, 2),), np.zeros((3, 8), np.uint8), device="cpu")
    few = {0: np.zeros(8, np.uint8), 4: np.zeros(8, np.uint8)}
    with pytest.raises(ValueError):
        ref.rs_reconstruct(few)
    with pytest.raises(ValueError):
        port.rs_reconstruct(few, device="cpu")
    with pytest.raises(ValueError):
        port.rs_encode(np.zeros((2, 8), np.uint8), device="cpu")


@pytest.mark.parametrize("coeffs", [
    tuple((1,) * 17 for _ in range(2)),   # K = 17
    tuple((1, 2) for _ in range(17)),     # M = 17
    ((1, 256),),                          # not a field element
    ((1, 2), (3,)),                       # ragged
    (),                                   # empty
], ids=["K17", "M17", "value", "ragged", "empty"])
def test_unsupported_matrices_raise(coeffs):
    K = len(coeffs[0]) if coeffs else 1
    with pytest.raises(ValueError):
        port.gf_matmul(coeffs, np.zeros((K, 8), np.uint8), device="cpu")


def test_zero_width_returns_empty_without_launch():
    before = port.LAUNCHES["gf_matmul"]
    out = port.gf_matmul(port.generator_matrix(3, 2),
                         np.zeros((3, 0), np.uint8), device="cpu")
    assert tuple(out.shape) == (2, 0) and out.dtype == torch.uint8
    assert port.LAUNCHES["gf_matmul"] == before


# --------------------------------------------- misaligned rows, ragged widths
# The realigned kernel path serves every row that is not 16-byte aligned
# with a width of a multiple of 16; the plain version must take any such
# row as it is, and the wrapper's launch shape must cover it.

RAGGED = [1, 15, 16, 17, 33, 4095, 4097]


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("offset", range(16))
def test_plain_on_offset_views_equals_table_ref(offset, n):
    rng = np.random.default_rng(100 * offset + n)
    coeffs = MATRICES["encode_2x3"] if n % 2 else MATRICES["zeros_3x3"]
    k = len(coeffs[0])
    buf = torch.from_numpy(rng.integers(0, 256, size=k * n + 16,
                                        dtype=np.uint8))
    view = buf[offset:offset + k * n].view(k, n)
    got = port.gf_matmul(coeffs, view)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.gf_matmul_ref(coeffs, view.numpy()))


@pytest.mark.parametrize("n", RAGGED + [4080, 4096, 22_369_622, 22_369_632])
def test_launch_shape_path_rule_and_cover(n):
    """The aligned path only for aligned rows (both base pointers 16-byte
    aligned and n % 16 == 0); every other case the realigned path. Its
    blocks own columns [b*4080 - e, (b+1)*4080 - e) of an output row
    misaligned by e, as 255 vectors each at columns 16k - e: for every e
    they cover the row exactly once, and the only partial vectors (byte
    stores) are the row's first and last, at most 15 bytes each."""
    for in_off, out_off in [(0, 0), (1, 0), (0, 7), (15, 15), (16, 32)]:
        vec16, blocks = port._launch_shape(n, 4096 + in_off, 8192 + out_off)
        aligned = n % 16 == 0 and in_off % 16 == 0 and out_off % 16 == 0
        assert vec16 == aligned
        if vec16:
            assert blocks * port._COLS >= n > (blocks - 1) * port._COLS
            continue
        assert port._STEP % 16 == 0
        per_block = port._STEP // 16
        b = np.repeat(np.arange(blocks, dtype=np.int64), per_block)
        v = np.tile(np.arange(per_block, dtype=np.int64), blocks)
        for e in range(16):
            c = b * port._STEP - e + 16 * v           # vector start columns
            hit = (c < n) & (c + 16 > 0)
            bytes_ = np.minimum(n, c[hit] + 16) - np.maximum(0, c[hit])
            assert bytes_.sum() == n                  # exactly once
            partial = np.flatnonzero(bytes_ < 16)
            assert set(partial) <= {0, len(bytes_) - 1}
            assert (bytes_[partial] <= 15).all()
        # no block to spare: one fewer would miss the tail when e = 15
        assert (blocks - 1) * port._STEP - 15 < n


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_kernel_launch_refuses_a_wrong_out_view(bad):
    """The launch writes `out` in place at any address; a view the kernel
    would overrun or misread is refused before any launch."""
    shards = torch.zeros((3, 64), dtype=torch.uint8)
    out = {"shape": torch.zeros((2, 63), dtype=torch.uint8),
           "dtype": torch.zeros((2, 64), dtype=torch.int32),
           "strided": torch.zeros((2, 128), dtype=torch.uint8)[:, ::2]}[bad]
    before = dict(port.LAUNCHES)
    with pytest.raises(ValueError, match="out must be"):
        port._launch(port.generator_matrix(3, 2), shards, out=out)
    assert port.LAUNCHES == before
