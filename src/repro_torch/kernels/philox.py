"""Plain version of the Philox bit generator: XLA's RngBitGenerator.

The reference's ``rbg`` and ``unsafe_rbg`` keys draw their bits with
``lax.rng_bit_generator(key, shape, uint32)``, which XLA runs as
Philox-4x32-10 (Random123's round constants) in this layout:

- the Philox key is words ``(w0, w1)`` of the 4-word key ``w``;
- the 128-bit counter of block i is ``C + i`` with ``C = w2 | w3<<32 |
  w0<<64 | w1<<96`` (the carry out of the low 64 bits runs into the words
  that hold ``w0, w1``);
- block i yields output words ``4i .. 4i+3`` in row-major order, and the
  output is cut to the draw's size (uint8 and uint16 draws take the low
  bits of one 32-bit word each).

The all-zero key gives Random123's known answer ``6627e8d5 e169c58d
bc57ac4c 9b00dbd8``. The CUDA kernel (``kernels/csrc/philox.cu``, one
thread per 4-word block) writes this layout; ``philox_bits_plain`` is the
version it is held against and what ``kernels/ops.philox_bits`` runs for a
draw on the CPU, in torch int64 operations (each 32×32 product from 16-bit
halves, so nothing overflows).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the constant ``m`` and the
    uint32 values ``c`` (int64)."""
    a = m * (c & 0xFFFF)                       # < 2**48
    b = m * (c >> 16)                          # < 2**48
    lo_full = a + ((b & 0xFFFF) << 16)         # < 2**49
    return (b >> 16) + (lo_full >> 32), lo_full & MASK32


def philox_block_words(words, blocks: torch.Tensor) -> torch.Tensor:
    """int64 ``[len(blocks), 4]``: the output words of Philox blocks
    ``blocks`` (int64 indices) of the key ``words`` (four ints)."""
    w0, w1, w2, w3 = (int(w) & MASK32 for w in words)
    # counter C + i over 32-bit limbs (w2, w3, w0, w1), carries included
    c0 = w2 + (blocks & MASK32)
    c1 = w3 + (blocks >> 32) + (c0 >> 32)
    c2 = w0 + (c1 >> 32)
    c3 = (w1 + (c2 >> 32)) & MASK32
    c0, c1, c2 = c0 & MASK32, c1 & MASK32, c2 & MASK32
    k0, k1 = w0, w1
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensors of the same bits."""
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)


def philox_bits_plain(words, n: int, *, start: int = 0,
                      device="cpu") -> torch.Tensor:
    """int32 ``[n]``: words ``[start, start + n)`` of the Philox stream of
    the 4-word key ``words`` (the uint32 bits as int32)."""
    b0 = start // 4
    b1 = -(-(start + n) // 4)
    blocks = torch.arange(b0, b1, dtype=torch.int64, device=device)
    out = philox_block_words(words, blocks).reshape(-1)
    off = start - 4 * b0
    return to_int32(out[off:off + n])

