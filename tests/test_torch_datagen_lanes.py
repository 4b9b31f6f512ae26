"""The pool kernels' launch plans and thread mappings (``csrc/datagen.cu``
D1 ``chacha_bits_kernel``, D2 ``channel_values_kernel<Channel, F>``), on
the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` holds
them to the plain versions there). Here each kernel's index arithmetic is
replayed in numpy over the launch that ``rng/chacha_torch.py``'s plan
mirrors give (the library is checked against the same mirrors before its
first launch): every thread of every block, its ChaCha8 block, its shared
memory addresses (D1's tile of words with its skew and swizzle, the 32
ballots of the bit transpose), its stores. The replay must write every
output element exactly once, with the plain version's value (reference
bits, packed words and channel values exact; the keystream from the plain
``chacha8_blocks``; ``tests/test_torch_datagen_device.py`` holds the plain
versions to the JAX package's). Also: which instantiation D2 takes (four
frames a store, or one) for aligned and unaligned column slices, and
``runtime/perf.py``'s terms of D2's work.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu_torch.rng import chacha_torch as ct  # noqa: E402
from ldpc_decoder_tpu_torch.runtime import perf  # noqa: E402

M32 = 0xFFFFFFFF
WRAP = 2**32 - 40


def _blocks(key0, key1, block):
    """ChaCha8 words [n, 16] (uint32 in int64) of block ``block`` [n] of
    the streams seeded (key0 [n], key1)."""
    key0 = torch.as_tensor(np.asarray(key0, np.int64) & M32)
    block = torch.as_tensor(np.asarray(block, np.int64))
    keys = torch.stack([key0, torch.full_like(key0, key1)])
    return ct.chacha8_blocks(keys, block % 24, block // 24).T.numpy()


def _spread(w):
    """[n] words -> [n, 32] bytes, bit f of each word in byte f."""
    return ((w[:, None] >> np.arange(32)) & 1).astype(np.int8)


# ---- D1 ---------------------------------------------------------------------

def replay_chacha_bits(start, n_vars, n_frames):
    """chacha_bits_kernel over its whole launch: (bits, packed, the number
    of writes of each bits and packed element)."""
    plan = ct.chacha_bits_plan(n_vars, n_frames)
    G, TB = plan["groups"], plan["blocks"]
    Gp, TW = G | 1, TB // 2
    chunks = TW // 4
    mask = min(chunks, 8) - 1
    frame_words = 16 * TB * Gp + TB  # the frame words' offset, in words
    n_groups, n_words = n_frames // 32, -(-n_vars // 32)
    bits = np.zeros((n_vars, n_frames), np.int8)
    packed = np.zeros((n_frames, n_words), np.int64)
    bits_writes = np.zeros((n_vars, n_frames), np.int64)
    packed_writes = np.zeros((n_frames, n_words), np.int64)
    assert (G * TB) % 32 == 0 and 256 <= G * TB <= 512 and TW >= 8
    assert plan["smem"] == 4 * (frame_words + 32 * G * TW)
    gl, bl = np.meshgrid(np.arange(G), np.arange(TB), indexing="xy")
    gl, bl = gl.reshape(-1), bl.reshape(-1)  # thread t = bl * G + gl
    t = bl * G + gl
    assert (t == np.arange(G * TB)).all()
    lane, warp = t & 31, t >> 5
    for by in range(plan["grid"][1]):
        for bx in range(plan["grid"][0]):
            smem = np.full(plan["smem"] // 4, -1, np.int64)
            g = by * G + gl
            block = bx * TB + bl
            v0 = 16 * block
            live = (g < n_groups) & (v0 < n_vars)
            w = _blocks(start + 32 * g, 0, block)
            for i in range(16):
                v, r = v0 + i, 16 * bl + i
                inn = live & (v < n_vars)
                addr = r * Gp + gl + (r >> 4)
                assert len(set(addr)) == addr.size
                assert (addr < frame_words).all()
                smem[addr] = np.where(inn, w[:, i], 0)
                if G % 2:  # each thread its own group's 32 bytes
                    rows = v[inn][:, None]
                    cols = 32 * g[inn][:, None] + np.arange(32)
                    bits[rows, cols] = _spread(w[inn, i])
                    np.add.at(bits_writes, (rows, cols), 1)
                    continue
                # paired: lane t writes half t % 2 of groups g & ~1 and
                # g | 1, the word of the other group from lane t ^ 1
                word = np.where(live, w[:, i], 0)
                half = gl & 1
                for e in range(2):
                    ge = (g & ~1) + e
                    ok = (v < n_vars) & (ge < n_groups)
                    src = np.where(half == e, t, t ^ 1)
                    assert (live[src[ok]]).all()
                    rows = v[ok][:, None]
                    cols = 32 * ge[ok][:, None] + 16 * half[ok][:, None] + (
                        np.arange(16))
                    spread = _spread(word[src[ok]])
                    bits[rows, cols] = np.take_along_axis(
                        spread, 16 * half[ok][:, None] + np.arange(16), 1)
                    np.add.at(bits_writes, (rows, cols), 1)
            assert (smem >= 0).sum() == 16 * TB * G
            n_warps = G * TB // 32
            for j in range(16):
                for wp in range(n_warps):
                    pair = 16 * wp + j
                    word, grp = pair % TW, pair // TW
                    r = 32 * word + np.arange(32)
                    xs = smem[r * Gp + grp + (r >> 4)]  # lane l: variable l
                    assert (xs >= 0).all()
                    # ballot f: bit l = bit f of lane l's word; lane f keeps it
                    mine = ((xs[None, :] >> np.arange(32)[:, None]) & 1) @ (
                        1 << np.arange(32, dtype=np.int64))
                    row = 32 * grp + np.arange(32)
                    addr = frame_words + row * TW + 4 * (
                        (word >> 2) ^ (row & mask)) + (word & 3)
                    assert (smem[addr] < 0).all()
                    smem[addr] = mine
            assert (smem[frame_words:] >= 0).all()
            for idx in range(32 * G * chunks):
                row, c = idx // chunks, idx % chunks
                frame = 32 * by * G + row
                word = bx * TW + 4 * c
                if frame >= n_frames or word >= n_words:
                    continue
                base = frame_words + row * TW + 4 * (c ^ (row & mask))
                q = smem[base:base + 4]
                k = min(4, n_words - word)
                packed[frame, word:word + k] = q[:k]
                packed_writes[frame, word:word + k] += 1
    return bits, packed, bits_writes, packed_writes


def _as_int32(words):
    return (words - ((words >> 31) << 32)).astype(np.int32)


@pytest.mark.parametrize("n_groups", [1, 2, 3, 16, 64, 20, 17])
@pytest.mark.parametrize("n_vars", [512, 1031])
def test_chacha_bits_replay_matches_plain(n_groups, n_vars):
    """D1's launch writes every bit and every packed word once, with the
    plain version's values, at 1, 2, 3, 16, 64, 20 and 17 groups (a last
    tile of one group, its pair lane writing nothing) and a ragged
    n_vars (zero bits past it in the last word)."""
    n_frames = 32 * n_groups
    bits, packed, bw, pw = replay_chacha_bits(WRAP, n_vars, n_frames)
    assert (bw == 1).all() and (pw == 1).all()
    plain = ct.reference_bits_plain(WRAP, n_vars, n_frames, "cpu")
    assert np.array_equal(bits, plain.numpy())
    assert np.array_equal(_as_int32(packed), ct.pack_rows(
        plain, -(-n_vars // 32)).numpy())


@pytest.mark.parametrize("n_groups,want_g,want_tb", [
    (1, 1, 256), (2, 2, 128), (3, 3, 128), (16, 16, 16), (64, 16, 16),
    (20, 10, 32), (17, 16, 16), (15, 15, 32), (7, 7, 64)])
def test_chacha_bits_plan_keeps_every_lane_busy(n_groups, want_g, want_tb):
    """A tile holds the real group count (up to 16; above, a divisor in
    [8, 16] where there is one), 256 to 512 threads in whole warps, and at
    least 8 words (a 32-byte sector) of each frame's run, in at most 64 KB
    of shared memory."""
    plan = ct.chacha_bits_plan(1032192, 32 * n_groups)
    assert (plan["groups"], plan["blocks"]) == (want_g, want_tb)
    threads = plan["groups"] * plan["blocks"]
    assert threads % 32 == 0 and 256 <= threads <= 512
    assert plan["blocks"] // 2 >= 8 and plan["smem"] <= 64 * 1024
    assert plan["grid"] == (-(-64512 // want_tb), -(-n_groups // want_g))
    # every group of every tile is a real one, except where no divisor
    # fits (17: a last tile of 1)
    assert (n_groups % want_g == 0) == (n_groups != 17)


def test_chacha_bits_plan_refuses():
    assert ct.chacha_bits_plan(100, 48) is None
    assert ct.chacha_bits_plan(0, 64) is None
    assert ct.chacha_bits_plan(100, 32 * 16 * 65536) is None
    assert ct.chacha_bits_plan(100, 32 * 16 * 65535) is not None


# ---- D2 ---------------------------------------------------------------------

def replay_channel_values(bits, start, channel, noise, n_tx, pos, frames,
                          ld):
    """channel_values_kernel<channel, frames == 4> over its whole launch
    into rows of ``ld`` floats: (values [n_vars, ld] with NaN where not
    written, the number of writes of each element, the (frame, ChaCha
    block) pairs whose keystream the threads compute). Each value is the
    plain version's at the (variable, frame) that the storing lane writes;
    in the vector instantiation the lane that computed it (frame f of
    block b, its thread b * n_frames + f) must be in the storing lane's
    warp and quad, and have staged it."""
    n_vars, n_frames = bits.shape
    plan = ct.channel_values_plan(channel, n_vars, n_frames, frames)
    per = plan["vars"]
    natural = ct.channel_values_plain(torch.as_tensor(bits), start, channel,
                                      noise).numpy()
    out = np.full((n_vars, ld), np.nan, np.float32)
    writes = np.zeros((n_vars, ld), np.int64)
    rows = np.arange(n_vars) if pos is None else pos
    assert plan["threads"] == n_frames * -(-n_vars // per) < 2**31
    t = np.arange(plan["grid"] * ct.VALUE_THREADS)
    active = t < plan["threads"]
    b = np.where(active, t, 0) // n_frames
    f = np.where(active, t, 0) % n_frames
    keystream = active & (per * b < n_tx)
    computed = int(keystream.sum())
    if frames == 1:
        for i in range(per):
            v = per * b + i
            ok = active & (v < n_vars)
            value = np.where(v[ok] < n_tx, natural[np.minimum(v[ok], n_vars
                                                              - 1), f[ok]], 0)
            out[rows[v[ok]], f[ok]] = value
            np.add.at(writes, (rows[v[ok]], f[ok]), 1)
        return out, writes, computed
    # staged[t, i]: what thread t staged for variable i (NaN: nothing)
    staged = np.full((t.size, per), np.nan)
    for i in range(per):
        v = per * b + i
        ok = keystream & (v < n_tx)
        staged[ok, i] = natural[v[ok], f[ok]]
    lane = t & 31
    q = lane & 7
    src = t - lane + 4 * q  # the quad's first thread (a shuffle from 4q)
    quad_ok = src < plan["threads"]
    bq, fq = b[np.minimum(src, t.size - 1)], f[np.minimum(src, t.size - 1)]
    for s in range(per // 4):
        i = (lane >> 3) + 4 * s
        v = per * bq + i
        ok = quad_ok & (v < n_vars)
        for k in range(4):
            # the value comes from lane 4q + k of the same warp
            owner = src + k
            assert (b[owner[ok]] == bq[ok]).all()
            assert (f[owner[ok]] == fq[ok] + k).all()
            tx_ok = ok & (v < n_tx)
            got = staged[owner[tx_ok], i[tx_ok]]
            assert not np.isnan(got).any()
            value = np.zeros(ok.sum())
            value[tx_ok[ok]] = got
            out[rows[v[ok]], fq[ok] + k] = value
            np.add.at(writes, (rows[v[ok]], fq[ok] + k), 1)
    return out, writes, computed


CASES = [  # (n_vars, n_tx, n_frames)
    (512, 512, 64),     # whole blocks
    (1031, 900, 64),    # ragged, an erased tail inside a block
    (200, 96, 8),       # the tail from a block boundary
    (37, 37, 6),        # n_frames not a multiple of 4: one lane only
]


@pytest.mark.parametrize("channel", ["bsc", "erasure", "awgn"])
@pytest.mark.parametrize("n_vars,n_tx,n_frames", CASES)
def test_channel_values_replay_matches_plain(channel, n_vars, n_tx,
                                             n_frames):
    """Both instantiations write each value of the slice once, the plain
    version's, in its sorted row, 0.0 in the erased tail, and compute a
    ChaCha block only for blocks below n_tx."""
    rng = np.random.default_rng(n_vars)
    bits = rng.integers(0, 2, (n_vars, n_frames)).astype(np.int8)
    pos = rng.permutation(n_vars).astype(np.int32)
    noise = {"bsc": 0.07, "erasure": 0.3, "awgn": 0.9}[channel]
    want = ct.channel_values_plain(torch.as_tensor(bits), WRAP, channel,
                                   noise, n_tx, torch.as_tensor(pos)).numpy()
    per = 8 if channel == "awgn" else 16
    for frames in (1, 4):
        if n_frames % frames:
            assert ct.channel_values_plan(channel, n_vars, n_frames,
                                          frames) is None
            continue
        ld = n_frames + 8
        out, writes, computed = replay_channel_values(
            bits, WRAP, channel, noise, n_tx, pos, frames, ld)
        assert (writes[:, :n_frames] == 1).all()
        assert (writes[:, n_frames:] == 0).all()
        assert np.array_equal(out[:, :n_frames].view(np.int32),
                              want.view(np.int32))
        assert computed == -(-n_tx // per) * n_frames


@pytest.mark.parametrize("offset,n_frames,want", [
    (0, 64, 4),    # a whole pool
    (64, 64, 4),   # a 16-byte aligned column slice
    (1, 64, 1),    # an odd offset
    (2, 64, 1),    # 8 bytes: not a 16-byte row
    (0, 6, 1),     # n_frames not a multiple of 4
    (4, 8, 4),     # 16 bytes in
])
def test_channel_values_instantiation(offset, n_frames, want):
    """Four frames a store where the rows start on 16 bytes (pointer and
    stride) and n_frames % 4 == 0, else one."""
    pool = torch.zeros((5, 3 * 64 + 4), dtype=torch.float32)
    assert pool.data_ptr() % 16 == 0
    bits = torch.zeros((5, n_frames), dtype=torch.int8)
    out = pool[:, offset:offset + n_frames]
    assert ct.channel_values_frames(out, bits) == want
    if want == 4:  # a row stride that breaks the rows' alignment
        odd = torch.zeros((5, 3 * 64 + 2))[:, offset:offset + n_frames]
        assert ct.channel_values_frames(odd, bits) == 1


@pytest.mark.parametrize("channel,per", [("bsc", 16), ("erasure", 16),
                                         ("awgn", 8)])
def test_channel_values_plan_grid(channel, per):
    """One thread per frame and ChaCha block, below 2^31 threads."""
    plan = ct.channel_values_plan(channel, 1032192, 512, 4)
    assert plan["vars"] == per and plan["frames"] == 4
    assert plan["threads"] == 512 * (1032192 // per)
    assert plan["grid"] == -(-plan["threads"] // 256)
    big = ct.channel_values_plan(channel, 1 << 28, 64, 4)
    assert (big is None) == (channel == "awgn")
    assert ct.channel_values_plan(channel, 1 << 27, 64, 4) is not None


# ---- runtime/perf.py: D2's work ---------------------------------------------

@pytest.mark.parametrize("channel", ["bsc", "erasure", "awgn"])
def test_channel_values_work_terms(channel):
    """Bytes (values written, transmitted bits and pos read), the integer
    pipe's operations (the block's 239 XORs and rotations) and the issued
    instructions (the block's 125 additions and 239 XORs and rotations,
    and per value its unit conversions and, for BI-AWGN, the accurate
    logf, cosf and sqrtf fast paths), blocks wholly in the erased tail
    skipped."""
    n_vars, n_tx, n = 1000, 700, 64
    per = 8 if channel == "awgn" else 16
    n_bytes, n_int, n_issue = perf.channel_values_work(channel, n_vars, n_tx,
                                                       n)
    blocks = n * -(-n_tx // per)
    assert n_bytes == 4 * n_vars * n + n_tx * n + 4 * n_vars
    assert n_int == blocks * 239
    libm = perf.LOGF_SASS + perf.COSF_SASS + perf.SQRTF_SASS
    per_value = (2 * perf.U2F_SASS + libm if channel == "awgn"
                 else perf.U2F_SASS)
    assert perf.channel_values_issue(channel) == 364 + per * per_value
    assert n_issue == blocks * (364 + per * per_value)
    assert perf.ISSUE_OPS_PER_S == 2 * perf.INT32_OPS_PER_S


def test_awgn_is_issue_bound_at_p41():
    """At p41 x 512 (n_tx = 884,736 of 1,032,192) BI-AWGN's issue term
    bounds it, above its bytes and its integer pipe; BSC at reg36 x 512 is
    bound by bytes under both terms."""
    b, i, s = perf.channel_values_work("awgn", 1032192, 884736, 512)
    issue = perf.bound(b, s, perf.ISSUE_OPS_PER_S)
    integer = perf.bound(b, i, perf.INT32_OPS_PER_S)
    assert issue[1] == "operations" and issue[0] > integer[0]
    assert issue[0] > b / perf.HBM_BYTES_PER_S * 1e3
    b, i, s = perf.channel_values_work("bsc", 1 << 20, 1 << 20, 512)
    assert perf.bound(b, s, perf.ISSUE_OPS_PER_S)[1] == "bytes"
    assert perf.bound(b, i, perf.INT32_OPS_PER_S)[1] == "bytes"
