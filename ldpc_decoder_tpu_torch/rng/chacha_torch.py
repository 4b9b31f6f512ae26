"""ChaCha8 frame generation in PyTorch: reference bits and channel values.

The port's counterpart of ``ldpc_decoder_tpu/rng/chacha_jax.py``: the same
(seed, word index) -> uint32 function as :mod:`.chacha_np`, evaluated over
whole pools, so a pool's reference bits and noise come from absolute frame
indices exactly as the reference draws them (main.cpp:474-481, 522):

- the 32-frame group g uses the stream seeded ``start + 32 g``; its word v
  holds variable v's bits of the group's frames (bit f = frame 32 g + f);
- frame f draws its noise from the stream seeded ``2^32 | (start + f)``:
  one unit per variable for the BSC (flip if u < p) and the erasure channel
  (erase if u < epsilon), two for BI-AWGN (Box-Muller on consecutive
  units, as the JAX package draws it: r = sqrt(-2 log u1),
  g = r cos(2 pi u2), value = tx + sigma g; the host datagen draws the
  reference's polar method instead, so AWGN values agree with it in
  distribution, not value for value).

The plain versions (``chacha8_blocks``, ``stream_words_2d``,
``units_from_words``, ``reference_bits_plain``, ``pack_rows``,
``channel_values_plain``) run on int64 tensors masked to 32 bits, since
torch has no uint32 shifts on the CPU; seeds wrap modulo 2^32 as JAX's
uint32 does, and the float steps are JAX's, each rounded in float32. They
run on any device.

The entry points (:func:`reference_bits_packed`, :func:`reference_bits`,
:func:`channel_values` and the per-channel :func:`bsc_values`,
:func:`erasure_values`, :func:`awgn_values`) take the device from their
arguments: on the CPU they run the plain versions; on a CUDA device they
launch ``csrc/datagen.cu``'s kernels (D1 ``chacha_bits_kernel``, D2
``channel_values_kernel``) or raise. There is no fallback from one to the
other. :func:`chacha_bits_plan` and :func:`channel_values_plan` mirror the
kernels' launches (the library's ``bits_plan`` and ``values_plan``, held to
them by :func:`check_library` before the first launch), and
:func:`channel_values_frames` picks D2's instantiation: four frames a
store (16-byte stores) where the output rows and the bits allow it, else
one.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ldpc_decoder_tpu_torch.rng.chacha_np import BLOCKS_PER_REFILL

MASK32 = 0xFFFFFFFF
NOISE_SEED_HI = 1  # the 2^32 flag of the noise seeds (main.cpp:522)
CHANNELS = ("bsc", "erasure", "awgn")
# 2 * float32(pi), the Box-Muller angle's factor as JAX computes it
TWO_PI_F32 = float(np.float32(2.0) * np.float32(np.pi))
_CONST = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


# ---- the plain versions --------------------------------------------------

def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _quarter_round(s, a, b, c, d) -> None:
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha8_blocks(key01: torch.Tensor, counters: torch.Tensor,
                   nonces: torch.Tensor) -> torch.Tensor:
    """ChaCha8 keystream blocks over the last axis -> [16, n] int64 holding
    uint32 values. ``key01`` [2, n]: key words 0..1 (2..7 are zero);
    ``counters`` [n] (< 24) and ``nonces`` [n]: the block's counter within
    its refill and the refill index (prng_chacha.cpp:39-67)."""
    n = counters.shape[0]
    z = torch.zeros(n, dtype=torch.int64, device=counters.device)
    init = [torch.full_like(z, c) for c in _CONST]
    init += [key01[0] & MASK32, key01[1] & MASK32, z, z, z, z, z, z]
    init += [counters.to(torch.int64), z, nonces.to(torch.int64), z]
    s = list(init)
    for _ in range(4):  # 8 rounds = 4 double rounds
        _quarter_round(s, 0, 4, 8, 12)
        _quarter_round(s, 1, 5, 9, 13)
        _quarter_round(s, 2, 6, 10, 14)
        _quarter_round(s, 3, 7, 11, 15)
        _quarter_round(s, 0, 5, 10, 15)
        _quarter_round(s, 1, 6, 11, 12)
        _quarter_round(s, 2, 7, 8, 13)
        _quarter_round(s, 3, 4, 9, 14)
    return torch.stack([(a + b) & MASK32 for a, b in zip(s, init)])


def stream_words_2d(seeds: torch.Tensor, n_words: int) -> torch.Tensor:
    """Words 0 .. n_words of each seed's stream -> [m, n_words] int64.
    ``seeds`` [2, m]: each seed's low and high 32 bits."""
    m = seeds.shape[1]
    n_blocks = -(-n_words // 16)
    blk = torch.arange(n_blocks, dtype=torch.int64, device=seeds.device)
    words = chacha8_blocks(seeds.repeat_interleave(n_blocks, dim=1),
                           (blk % BLOCKS_PER_REFILL).repeat(m),
                           (blk // BLOCKS_PER_REFILL).repeat(m))
    return words.T.reshape(m, n_blocks * 16)[:, :n_words]


def units_from_words(words: torch.Tensor) -> torch.Tensor:
    """rng.h:38-42: (float32(w) + 0.5) * 2^-32, rounded at each step (the
    int64 -> float32 cast rounds to nearest, as uint32 -> float32 does)."""
    return (words.to(torch.float32) + 0.5) * 2.0**-32


def _group_seeds(start: int, n_groups: int, device) -> torch.Tensor:
    lo = (start + 32 * torch.arange(n_groups, dtype=torch.int64,
                                    device=device)) & MASK32
    return torch.stack([lo, torch.zeros_like(lo)])


def _noise_seeds(start: int, n_frames: int, device) -> torch.Tensor:
    lo = (start + torch.arange(n_frames, dtype=torch.int64,
                               device=device)) & MASK32
    return torch.stack([lo, torch.full_like(lo, NOISE_SEED_HI)])


def reference_bits_plain(start: int, n_vars: int, n_frames: int,
                         device) -> torch.Tensor:
    """[n_vars, n_frames] int8 reference bits (main.cpp:478-487); n_frames
    a multiple of 32."""
    _check_frames(n_frames)
    n_groups = n_frames // 32
    words = stream_words_2d(_group_seeds(start, n_groups, device), n_vars)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1  # [n_groups, n_vars, 32]
    return bits.transpose(0, 1).reshape(n_vars, n_frames).to(torch.int8)


def pack_rows(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """bits [n_vars, n] in natural order -> [n, n_words] int32 holding each
    frame's uint32 words (bit j of word w = variable 32 w + j, zero past
    n_vars; ``datagen_device.py:35`` ``_pack_rows`` of the JAX package)."""
    n_vars, n = bits.shape
    pad = n_words * 32 - n_vars
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad, n))])
    x = bits.reshape(n_words, 32, n).to(torch.int64)
    words = torch.zeros((n_words, n), dtype=torch.int64, device=bits.device)
    for j in range(32):
        words |= x[:, j] << j
    # [0, 2^32) -> the int32 with the same bit pattern
    words -= (words >> 31) << 32
    return words.to(torch.int32).T.contiguous()


def channel_values_plain(ref_bits: torch.Tensor, start: int, channel: str,
                         noise: float, n_tx: int | None = None,
                         pos: torch.Tensor | None = None) -> torch.Tensor:
    """[n_vars, n_frames] float32 channel values of the transmitted bits
    ``ref_bits`` [n_vars, n_frames] (natural order), JAX's float steps:
    BSC ±1 flipped where u < float32(p), erasure ±1 or 0.0 where
    u < float32(epsilon), AWGN tx + float32(sigma) * g; variables from
    ``n_tx`` on get 0.0, and variable v goes to row ``pos[v]`` when
    ``pos`` is given."""
    vals = _channel_values_natural(ref_bits, start, channel, noise)
    if n_tx is not None:
        vals[n_tx:] = 0.0
    if pos is not None:
        vals = torch.empty_like(vals).index_copy_(0, pos.long(), vals)
    return vals


def _channel_values_natural(ref_bits, start, channel, noise):
    n_vars, n_frames = ref_bits.shape
    seeds = _noise_seeds(start, n_frames, ref_bits.device)
    tx = torch.where(ref_bits > 0, 1.0, -1.0).to(torch.float32)
    noise32 = float(np.float32(noise))
    if channel == "awgn":
        u = units_from_words(stream_words_2d(seeds, 2 * n_vars))
        u1, u2 = u[:, 0::2].T, u[:, 1::2].T
        r = torch.sqrt(-2.0 * torch.log(u1))
        g = r * torch.cos(TWO_PI_F32 * u2)
        return tx + noise32 * g
    if channel not in CHANNELS:
        raise ValueError(f"unknown channel {channel!r}")
    hit = units_from_words(stream_words_2d(seeds, n_vars)).T < noise32
    return torch.where(hit, -tx if channel == "bsc" else 0.0, tx)


# ---- the kernels' launch plans (csrc/datagen.cu) ---------------------------

BITS_MAX_GROUPS = 16  # D1: groups of a tile, at most
BITS_MIN_BLOCKS = 16  # D1: ChaCha blocks of a tile, at least
BITS_THREADS = 256    # D1: a tile's threads, at least
BITS_MAX_SMEM = 64 * 1024  # D1: a tile's shared bytes, at most
VALUE_THREADS = 256   # D2: threads a block
VEC_FRAMES = 4        # D2: frames a store in the vector instantiation
_INT31 = 2**31 - 1


def chacha_bits_plan(n_vars: int, n_frames: int) -> dict | None:
    """D1's launch (``bits_plan``), or None where no launch takes the
    shape: ``groups`` G (the tile's 32-frame groups, threadIdx.x: the group
    count up to 16; above it its largest divisor in [8, 16], else 16),
    ``blocks`` TB (its ChaCha blocks, threadIdx.y: the least power of two
    >= 16 with G * TB >= 256 threads in whole warps, so each frame's run is
    TB / 2 >= 8 words), ``grid`` (x over the variables, y over the groups)
    and ``smem`` (bytes: the tile's variable words [16 TB][G | 1] with a
    one-word skew every 16 rows, then its frame words [32 G][TB / 2])."""
    if n_vars < 1 or n_frames < 32 or n_frames % 32:
        return None
    n_groups = n_frames // 32
    g = n_groups
    if n_groups > BITS_MAX_GROUPS:
        g = next((d for d in range(BITS_MAX_GROUPS, 7, -1)
                  if n_groups % d == 0), BITS_MAX_GROUPS)
    tb = BITS_MIN_BLOCKS
    while g * tb < BITS_THREADS or (g * tb) % 32:
        tb *= 2
    grid = (-(-(-(-n_vars // 16)) // tb), -(-n_groups // g))
    smem = 4 * (16 * tb * (g | 1) + tb + 16 * g * tb)
    if grid[1] > 65535 or smem > BITS_MAX_SMEM:
        return None
    return dict(groups=g, blocks=tb, grid=grid, smem=smem)


def channel_values_plan(channel: str, n_vars: int, n_frames: int,
                        frames: int) -> dict | None:
    """D2's launch (``values_plan``) with ``frames`` frames a store (4: the
    vector instantiation, or 1), or None where none takes it: ``vars``
    (variables of a ChaCha block: 8 for AWGN, 16 else), ``frames``,
    ``threads`` (one per frame and ChaCha block) and ``grid`` (blocks of
    VALUE_THREADS)."""
    if (n_vars < 1 or n_frames < 1 or channel not in CHANNELS
            or frames not in (1, VEC_FRAMES) or n_frames % frames):
        return None
    per = 8 if channel == "awgn" else 16
    threads = n_frames * -(-n_vars // per)
    grid = -(-threads // VALUE_THREADS)
    if grid * VALUE_THREADS > _INT31:
        return None
    return dict(vars=per, frames=frames, threads=threads, grid=grid)


def channel_values_frames(values: torch.Tensor, bits: torch.Tensor) -> int:
    """D2's frames a store for rows ``values`` [n_vars, n_frames] (its row
    stride taken from the tensor) and ``bits`` [n_vars, n_frames]: 4 where
    n_frames is a multiple of 4, each row of values starts on 16 bytes and
    bits on 4 (one 4-byte load of a variable's four bits, one 16-byte store
    of its four values); else 1."""
    n_frames = values.shape[1]
    vec = (n_frames % VEC_FRAMES == 0 and values.data_ptr() % 16 == 0
           and values.stride(0) % 4 == 0 and bits.data_ptr() % 4 == 0)
    return VEC_FRAMES if vec else 1


# shapes the load check compares with the library: 1, 2, 3, 16, 64, 17,
# 20 and 34 groups; ragged and one-block variable counts; p41 and reg36;
# frame counts D1 refuses; a grid D2 refuses at one frame a thread
_PLAN_SHAPES = [(1, 32), (16, 64), (1031, 96), (4101, 512), (512, 2048),
                (100, 544), (100, 640), (100, 1088), (1032192, 512),
                (1048576, 64), (7, 5), (7, 6), (1 << 28, 64)]


def check_library(lib) -> None:
    """Raise RuntimeError unless the library's launch plans are
    :func:`chacha_bits_plan`'s and :func:`channel_values_plan`'s and its
    vector frames VEC_FRAMES."""
    if lib.ldpc_channel_values_vec_frames() != VEC_FRAMES:
        raise RuntimeError("datagen library and VEC_FRAMES disagree")
    bits_out = (ctypes.c_int * 5)()
    vals_out = (ctypes.c_longlong * 4)()
    for n_vars, n_frames in _PLAN_SHAPES:
        err = lib.ldpc_chacha_bits_plan(n_vars, n_frames, bits_out)
        got = None if err else dict(groups=bits_out[0], blocks=bits_out[1],
                                    grid=(bits_out[2], bits_out[3]),
                                    smem=bits_out[4])
        if got != chacha_bits_plan(n_vars, n_frames):
            raise RuntimeError(f"datagen library and chacha_bits_plan "
                               f"disagree at {n_vars} x {n_frames}: {got}")
        for channel, code in (("bsc", 0), ("erasure", 1), ("awgn", 2)):
            for frames in (1, VEC_FRAMES):
                err = lib.ldpc_channel_values_plan(code, n_vars, n_frames,
                                                   frames, vals_out)
                got = None if err else dict(
                    vars=vals_out[0], frames=vals_out[1],
                    threads=vals_out[2], grid=vals_out[3])
                want = channel_values_plan(channel, n_vars, n_frames, frames)
                if got != want:
                    raise RuntimeError(
                        f"datagen library and channel_values_plan disagree "
                        f"at {channel} {n_vars} x {n_frames}, {frames} "
                        f"frames: {got} != {want}")


_library_checked = False


def _library():
    """The datagen library (``_kernels.load("datagen")``), held to the
    plans by :func:`check_library` the first time."""
    global _library_checked
    from ldpc_decoder_tpu_torch.ops import _kernels

    lib = _kernels.load("datagen")
    if not _library_checked:
        check_library(lib)
        _library_checked = True
    return lib


# ---- the entry points: plain on the CPU, kernels on the card ---------------

def _check_frames(n_frames: int) -> None:
    if n_frames < 32 or n_frames % 32:
        raise ValueError(f"pool generation needs a multiple of 32 frames, "
                         f"got {n_frames}")


def _backend(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no implementation for device {device}: pools "
                         f"are generated on the CPU (plain) or CUDA "
                         f"(kernels)")
    return device.type


def reference_bits_packed(start: int, n_vars: int, n_frames: int,
                          device) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits [n_vars, n_frames] int8 in natural order, packed
    [n_frames, ceil(n_vars / 32)] int32) of the frames ``start`` ..
    ``start + n_frames`` on ``device``; n_frames a multiple of 32."""
    _check_frames(n_frames)
    device = torch.device(device)
    n_words = (n_vars + 31) // 32
    if _backend(device) == "cpu":
        bits = reference_bits_plain(start, n_vars, n_frames, device)
        return bits, pack_rows(bits, n_words)
    from ldpc_decoder_tpu_torch.ops import _kernels

    _library()
    bits = torch.empty((n_vars, n_frames), dtype=torch.int8, device=device)
    packed = torch.empty((n_frames, n_words), dtype=torch.int32,
                         device=device)
    with torch.cuda.device(device):
        _kernels.chacha_bits(bits, packed, start & MASK32, n_vars, n_frames,
                             n_words)
    return bits, packed


def reference_bits(start: int, n_vars: int, n_frames: int,
                   device) -> torch.Tensor:
    """[n_vars, n_frames] int8 reference bits (``chacha_jax.py:107``
    ``reference_bits_device``)."""
    return reference_bits_packed(start, n_vars, n_frames, device)[0]


def channel_values(ref_bits: torch.Tensor, start: int, channel: str,
                   noise: float, n_tx: int | None = None,
                   pos: torch.Tensor | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Channel values of ``ref_bits`` [n_vars, n_frames] (natural order) on
    its device: variables from ``n_tx`` on (the erased tail) get 0.0, and
    variable v goes to row ``pos[v]`` (int32, natural -> the decoder's
    sorted order) when given. ``out`` [n_vars, n_frames] float32 (its rows
    may be longer: a column slice of a pool) is written and returned."""
    if channel not in CHANNELS:
        raise ValueError(f"unknown channel {channel!r}")
    n_vars, n_frames = ref_bits.shape
    n_tx = n_vars if n_tx is None else n_tx
    if not 0 <= n_tx <= n_vars:
        raise ValueError(f"n_tx {n_tx} outside [0, {n_vars}]")
    if out is None:
        out = torch.empty((n_vars, n_frames), dtype=torch.float32,
                          device=ref_bits.device)
    if tuple(out.shape) != (n_vars, n_frames) or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 [{n_vars}, {n_frames}]")
    if pos is not None and (pos.dtype != torch.int32
                            or tuple(pos.shape) != (n_vars,)):
        raise ValueError(f"pos must be int32 [{n_vars}]")
    devices = {ref_bits.device, out.device} | (
        {pos.device} if pos is not None else set())
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if _backend(ref_bits.device) == "cpu":
        return out.copy_(channel_values_plain(ref_bits, start, channel,
                                              noise, n_tx, pos))
    if ref_bits.dtype != torch.int8 or not ref_bits.is_contiguous():
        raise ValueError("the kernel takes contiguous int8 bits")
    if out.stride(1) != 1 or (pos is not None and not pos.is_contiguous()):
        raise ValueError("the kernel writes rows of unit stride and reads a "
                         "contiguous pos")
    from ldpc_decoder_tpu_torch.ops import _kernels

    _library()
    with torch.cuda.device(ref_bits.device):
        _kernels.channel_values(out, ref_bits, pos, start & MASK32, n_vars,
                                n_tx, n_frames, channel, noise,
                                channel_values_frames(out, ref_bits))
    return out


def _values(ref_bits, start, n_vars, n_frames, channel, noise):
    if tuple(ref_bits.shape) != (n_vars, n_frames):
        raise ValueError(f"ref_bits must be [{n_vars}, {n_frames}]")
    return channel_values(ref_bits, start, channel, noise)


def bsc_values(ref_bits, start: int, n_vars: int, n_frames: int,
               p: float) -> torch.Tensor:
    """±1 BSC values, flipped where u < p (``chacha_jax.py:142``)."""
    return _values(ref_bits, start, n_vars, n_frames, "bsc", p)


def erasure_values(ref_bits, start: int, n_vars: int, n_frames: int,
                   epsilon: float) -> torch.Tensor:
    """±1, or 0.0 where u < epsilon (``chacha_jax.py:159``)."""
    return _values(ref_bits, start, n_vars, n_frames, "erasure", epsilon)


def awgn_values(ref_bits, start: int, n_vars: int, n_frames: int,
                sigma: float) -> torch.Tensor:
    """±1 + sigma * N(0, 1) by Box-Muller (``chacha_jax.py:176``)."""
    return _values(ref_bits, start, n_vars, n_frames, "awgn", sigma)
