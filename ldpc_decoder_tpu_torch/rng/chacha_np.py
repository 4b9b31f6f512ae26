"""Seekable ChaCha8 PRNG — vectorized numpy implementation.

Reproduces, stream-for-stream, the reference's PRNG semantics
(src/prng_chacha.cpp:28-67 + the Goll–Gueron core in chacha_stream.cpp):

- ChaCha with 8 rounds; state row 3 = [counter_lo, counter_hi, nonce_lo,
  nonce_hi] (the original DJB variant, chacha_stream.cpp:119).
- Key = 8 words, of which words 0..1 hold the 64-bit seed, the rest are 0
  (prng_chacha.cpp:39-49).
- The stream is produced in 1536-byte refills (24 blocks); each refill runs
  the cipher with counter starting at 0 and the *nonce* equal to the refill
  index (prng_chacha.cpp:62-67). Hence the j-th 32-bit word of the stream
  for a given seed is word ``j%16`` of the block with
  ``nonce = j//384`` and ``counter = (j%384)//16`` — a pure function of
  (seed, j), which is what makes every frame reproducible by index alone.

Derived draws mirror h/rng.h: ``unit = (float32(u32) + 0.5) * 2^-32``
(rng.h:38-42) and gaussians via the polar Box–Muller rejection with pair
caching (rng.h:49-70), all in float32.

JAX-free copy of ``ldpc_decoder_tpu/rng/chacha_np.py``, held equal to it and
to ``tests/data/chacha_golden.txt`` by ``tests/test_torch_host.py``; the same
stream is produced natively by :mod:`ldpc_decoder_tpu_torch.native` for bulk
data generation.
"""

from __future__ import annotations

import numpy as np

_CONST = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)

WORDS_PER_REFILL = 384  # 1536 bytes (prng_chacha.cpp:28)
BLOCKS_PER_REFILL = 24


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter_round(s, a, b, c, d):
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha_blocks(
    key_words: np.ndarray,
    counters: np.ndarray,
    nonces: np.ndarray,
    rounds: int = 8,
) -> np.ndarray:
    """Compute ChaCha blocks, vectorized over the last axis.

    key_words: [8] or [8, N] uint32; counters/nonces: [N] uint64.
    Returns [16, N] uint32 — each column is one 64-byte keystream block as
    sixteen little-endian words.
    """
    counters = np.asarray(counters, dtype=np.uint64)
    nonces = np.asarray(nonces, dtype=np.uint64)
    n = counters.shape[0]
    key_words = np.asarray(key_words, dtype=np.uint32)
    if key_words.ndim == 1:
        key_words = np.broadcast_to(key_words[:, None], (8, n))

    init = np.empty((16, n), dtype=np.uint32)
    init[0:4] = _CONST[:, None]
    init[4:12] = key_words
    init[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    init[13] = (counters >> np.uint64(32)).astype(np.uint32)
    init[14] = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    init[15] = (nonces >> np.uint64(32)).astype(np.uint32)

    s = init.copy()
    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            _quarter_round(s, 0, 4, 8, 12)
            _quarter_round(s, 1, 5, 9, 13)
            _quarter_round(s, 2, 6, 10, 14)
            _quarter_round(s, 3, 7, 11, 15)
            _quarter_round(s, 0, 5, 10, 15)
            _quarter_round(s, 1, 6, 11, 12)
            _quarter_round(s, 2, 7, 8, 13)
            _quarter_round(s, 3, 4, 9, 14)
        s += init
    return s


def _seed_key(seed: int) -> np.ndarray:
    key = np.zeros(8, dtype=np.uint32)
    key[0] = seed & 0xFFFFFFFF
    key[1] = (seed >> 32) & 0xFFFFFFFF
    return key


def stream_words(seed: int, start: int, count: int) -> np.ndarray:
    """Words ``start .. start+count`` of the buffered stream for ``seed``."""
    if count == 0:
        return np.zeros((0,), dtype=np.uint32)
    first_block = start // 16
    last_block = (start + count - 1) // 16
    blocks = np.arange(first_block, last_block + 1, dtype=np.uint64)
    nonces = blocks // np.uint64(BLOCKS_PER_REFILL)
    counters = blocks % np.uint64(BLOCKS_PER_REFILL)
    words = chacha_blocks(_seed_key(seed), counters, nonces)
    flat = words.T.reshape(-1)  # block-major word stream
    off = start - first_block * 16
    return flat[off : off + count]


def units_from_words(words: np.ndarray) -> np.ndarray:
    """rng.h:38-42 in float32: (float(u32) + 0.5) * 2^-32."""
    return (
        (words.astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-32)
    )


class PrngChacha:
    """Buffered, seekable ChaCha8 PRNG with the reference's draw semantics."""

    def __init__(self, seed: int = 0):
        self.reset_seed(seed)

    def reset_seed(self, seed: int) -> None:
        self._seed = int(seed)
        self._pos = 0  # next stream word index
        self._g_next: float | None = None  # Box–Muller pair cache

    # -- scalar interface (mirrors h/rng.h) ---------------------------------
    def random_int(self) -> int:
        w = stream_words(self._seed, self._pos, 1)[0]
        self._pos += 1
        return int(w)

    def unit(self) -> np.float32:
        return units_from_words(
            np.array([self.random_int()], dtype=np.uint32)
        )[0]

    def biased_bool(self, p: float) -> bool:
        return bool(self.unit() < np.float32(p))

    def gaussian(self) -> np.float32:
        if self._g_next is not None:
            out = self._g_next
            self._g_next = None
            return np.float32(out)
        while True:
            x = np.float32(2.0) * self.unit() - np.float32(1.0)
            y = np.float32(2.0) * self.unit() - np.float32(1.0)
            sqnorm = x * x + y * y
            if 0 < sqnorm < 1:
                break
        modulus = np.sqrt(
            (np.float32(-2.0) * np.log(sqnorm)) / sqnorm
        )
        self._g_next = y * modulus
        return np.float32(x * modulus)

    # -- bulk interface (vectorized, same streams) ---------------------------
    def random_ints(self, count: int) -> np.ndarray:
        out = stream_words(self._seed, self._pos, count)
        self._pos += count
        return out

    def units(self, count: int) -> np.ndarray:
        return units_from_words(self.random_ints(count))

    def gaussians(self, count: int) -> np.ndarray:
        """Vectorized polar Box–Muller, draw-for-draw identical to looping
        :meth:`gaussian` ``count`` times (rng.h:49-70)."""
        out = np.empty(count, dtype=np.float32)
        filled = 0
        if self._g_next is not None and count > 0:
            out[0] = self._g_next
            self._g_next = None
            filled = 1
        need_pairs = (count - filled + 1) // 2
        got: list[np.ndarray] = []  # accepted (x, y, sqnorm) columns
        got_pairs = 0
        while got_pairs < need_pairs:
            # expected acceptance is π/4; draw with ~30% slack
            todo = need_pairs - got_pairs
            n_draw = max(64, int(todo * 2 / 0.78) + 16) & ~1
            u = self.units(n_draw)
            x = np.float32(2.0) * u[0::2] - np.float32(1.0)
            y = np.float32(2.0) * u[1::2] - np.float32(1.0)
            sq = x * x + y * y
            ok = (sq > 0) & (sq < 1)
            n_ok = int(ok.sum())
            take = min(n_ok, todo)
            if take:
                sel = np.nonzero(ok)[0][:take]
                got.append(np.stack([x[sel], y[sel], sq[sel]]))
                got_pairs += take
                # Once satisfied, rewind the stream to just after the last
                # accepted pair so the position matches the scalar loop.
                if got_pairs == need_pairs:
                    last_kept = int(sel[-1])
                    self._pos -= n_draw - 2 * (last_kept + 1)
        if need_pairs:
            x, y, sq = np.concatenate(got, axis=1)
            with np.errstate(divide="ignore"):
                modulus = np.sqrt((np.float32(-2.0) * np.log(sq)) / sq)
            pair_vals = np.empty(2 * need_pairs, dtype=np.float32)
            pair_vals[0::2] = x * modulus
            pair_vals[1::2] = y * modulus
            n_take = count - filled
            out[filled:] = pair_vals[:n_take]
            if n_take < 2 * need_pairs:
                self._g_next = float(pair_vals[n_take])
        return out
