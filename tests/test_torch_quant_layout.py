"""How the DP kernels read a quantized ranking table (csrc/affine_dp.cu,
csrc/wsb_dp.cu), held on the CPU where no kernel runs.

- The packed rows' int8 -> f32 conversion without the convert instruction
  (csrc/affine_dp.cu ``int8_byte_f32``): the bytes xor 0x80, one byte
  permute under the bits of 12,582,912.0f, one f32 subtract of
  12,583,040.0f.  Emulated here in numpy on the bit patterns, it gives
  every one of the 256 bytes' values exactly (that the kernel computes
  what is emulated is held on the card, bit for bit, by chip_smoke.py
  phase 3b); the bf16 shift and mask give every finite bf16 value.
- The query-major copy the affine kernel reads (``affine_kernel_table``) is
  the [V, Tpad, Q] table element for element, the same storage at Q = 1,
  padded with zero columns to whole 8-column chunks.
"""

import numpy as np
import pytest
import torch

from vectorian_tpu_torch.ops import dp_kernels

# csrc/affine_dp.cu's INT8_BIAS_BITS (12,582,912.0f) and INT8_BIAS
INT8_BIAS_BITS = np.uint32(0x4B400000)
INT8_BIAS = np.float32(12583040.0)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes y:x (x's bytes 0-3)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for n in range(4):
        sel = (s >> (4 * n)) & 0xF
        assert sel < 8  # no sign-replicating selector
        byte = (both >> np.uint64(8 * sel)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def _as_f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


ALL_BYTES = np.arange(-128, 128, dtype=np.int32).astype(np.int8)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_int8_conversion_is_exact_for_every_byte(k):
    """int8_byte_f32 of byte k of a packed word (its other bytes random)
    gives float(b) for all 256 bytes, bit for bit (+0.0 for 0), the
    subtract rounded once in f32."""
    u = ALL_BYTES.view(np.uint8).astype(np.uint32)
    rng = np.random.default_rng(k)
    word = rng.integers(0, 2**32, size=u.shape, dtype=np.uint64).astype(np.uint32)
    word = (word & ~np.uint32(0xFF << (8 * k))) | (u << np.uint32(8 * k))
    raw = _byte_perm(word ^ np.uint32(0x80808080), np.full_like(word, INT8_BIAS_BITS),
                     0x7650 | k)
    got = (_as_f32(raw) - INT8_BIAS).astype(np.float32)
    want = ALL_BYTES.astype(np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _finite_bf16():
    """Every finite bf16 bit pattern and its value (torch's bf16 -> f32)."""
    pats = np.arange(2**16, dtype=np.uint32)
    pats = pats[((pats >> 7) & 0xFF) != 0xFF]
    vals = torch.from_numpy(pats.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    return pats, vals.float().numpy()


@pytest.mark.parametrize("half", ["low_shift", "high_mask"])
def test_bf16_shift_and_mask_are_exact(half):
    """A packed word of two bf16 columns: the low one is ``w << 16``, the
    high one ``w & 0xffff0000`` (load_packed / unpack_row, load4,
    load_pair), each the bf16 value for every finite pattern."""
    pats, want = _finite_bf16()
    other = np.random.default_rng(1).integers(0, 2**16, size=pats.shape).astype(np.uint32)
    if half == "low_shift":
        word = (other << np.uint32(16)) | pats
        got = _as_f32(word << np.uint32(16))
    else:
        word = (pats << np.uint32(16)) | other
        got = _as_f32(word & np.uint32(0xFFFF0000))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _table(dtype, V, Tpad, Q, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(V, Tpad, Q)).astype(np.float32)
    if dtype == torch.int8:
        return torch.from_numpy(np.round(x * 127.0).astype(np.int8))
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("Q", [1, 3, 32])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_query_major_table_is_the_table(dtype, Q):
    """The register route's quantized table: [V, Q, Tpad], element (v, q,
    j) the table's (v, j, q), contiguous and 16-byte aligned; at Q = 1 the
    table's own storage."""
    table = _table(dtype, 13, 16, Q, Q)
    got = dp_kernels.affine_kernel_table(table, "registers")
    assert got.shape == (13, Q, 16) and got.dtype == dtype and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    for v, q, j in ((0, 0, 0), (12, Q - 1, 15), (7, Q // 2, 9)):
        assert got[v, q, j].item() == table[v, j, q].item()
    assert torch.equal(got, table.permute(0, 2, 1))
    assert (got.data_ptr() == table.data_ptr()) == (Q == 1)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_query_major_table_pads_to_whole_chunks(dtype):
    """A Tpad off a multiple of 8 gets zero columns up to the next one (the
    kernel reads columns past Tpad as zeros anyway); an f32 table stays as
    it is on the register route and goes query-major on a wide one."""
    table = _table(dtype, 5, 12, 3, 4)
    got = dp_kernels.affine_kernel_table(table, "registers")
    assert got.shape == (5, 3, 16)
    assert torch.equal(got[:, :, :12], table.permute(0, 2, 1))
    assert not got[:, :, 12:].float().abs().sum()
    f32 = _table(torch.float32, 5, 12, 3, 4)
    assert dp_kernels.affine_kernel_table(f32, "registers") is f32
    wide = dp_kernels.affine_kernel_table(f32, "wide_regs")
    assert wide.shape == (5, 3, 12) and torch.equal(wide, f32.permute(0, 2, 1))


@pytest.mark.parametrize("Q", [1, 3, 32])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_wsb_paired_table_is_the_table(dtype, Q):
    """Kernel 3's register route: a quantized table at an even Q is paired,
    [V, Q / 2, Tpad, 2] with element (v, q // 2, j, q % 2) the table's (v,
    j, q); at an odd Q query-major [V, Q, Tpad] (at Q = 1 the same
    storage)."""
    table = _table(dtype, 13, 8, Q, 10 + Q)
    got = dp_kernels.wsb_register_table(table)
    assert got.dtype == dtype and got.is_contiguous() and got.data_ptr() % 4 == 0
    if Q % 2:
        assert torch.equal(got, table.permute(0, 2, 1))
        assert (got.data_ptr() == table.data_ptr()) == (Q == 1)
        return
    assert got.shape == (13, Q // 2, 8, 2)
    flat = got.reshape(-1)
    for v, q, j in ((0, 0, 0), (12, Q - 1, 7), (5, Q // 2 + 1, 3)):
        assert flat[((v * Q // 2 + q // 2) * 8 + j) * 2 + q % 2].item() == table[v, j, q].item()
    assert torch.equal(got.permute(0, 1, 3, 2).reshape(13, Q, 8), table.permute(0, 2, 1))
