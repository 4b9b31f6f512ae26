"""Plain float32 sum-product flood decoding: the reference that judges the
program's answers.

Plain PyTorch on the edges of :class:`pbcore.graph.Buckets`, written from
the algorithm and not from the program, whose modules it never imports.
Messages are LLRs with bit 1 as the positive sign (the program's
convention: a bit b is sent as 2b - 1). One iteration:

- check node, per check of degree d with syndrome bit s: the magnitudes
  a_j = phi(|q_j|), phi(x) = log((e^x + 1) / (e^x - 1)) evaluated as
  log1p(2 / expm1(x)), exact to float32 rounding over the whole range;
  r_k = phi(sum_j a_j - a_k) with the sign that makes the check hold:
  negative when (the number of negative q_j, j != k) + d + s is odd;
- variable node: total = L + sum_j r_j, q_k = total - r_k, the hard bit
  1 where the total's sign bit is clear.

phi's input is floored at ``phi_floor`` (the decoder's infinity threshold,
1e-5 by default, which caps a check message at phi(1e-5) = 12.2), the one
parameter the algorithm states besides the schedule.

The schedule is the configuration's: a frame decoded from the start of a
call is checked after max(first_check, k) iterations and every k after;
a frame that refills a lane is checked every k iterations of its own,
counted from the refill, whose first iteration resets the lane (so its
count is one more than the iterations it ran); a frame still violating a
check at a count of ``max_iterations`` or more retires at that check with
its hard decisions. The reference runs the same schedule and gives, for
each frame, the count at which it retires, its words (32 hard bits a
word, bit j of word w the variable 32w + j, as the program packs them)
and whether its words satisfy the frame's syndrome.
"""

from __future__ import annotations

import torch

from pbcore import cell

# frames decoded at once: each float32 message array of a 2^20-bit code's
# ~3.2 million edges is then ~1.7 GB
BLOCK_FRAMES = 128


def phi(x: torch.Tensor, floor: float) -> torch.Tensor:
    """phi(x) = -log(tanh(x / 2)) for x >= 0, its input floored."""
    return torch.log1p(2.0 / torch.expm1(x.clamp(min=floor)))


def channel_llr(values: torch.Tensor, channel: str,
                noise: float) -> torch.Tensor:
    """Channel values -> float32 LLRs by the channel's module
    ``channels/<channel>.py`` (0.0 stays 0.0: no information)."""
    return cell.channel(channel).llr(values, noise)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """[n_vars, F] 0/1 -> [F, n_words] int32 holding uint32 bit patterns."""
    n_vars, f = bits.shape
    n_words = -(-n_vars // 32)
    padded = torch.zeros((n_words * 32, f), dtype=torch.int64,
                         device=bits.device)
    padded[:n_vars] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (padded.view(n_words, 32, f) << shifts[None, :, None]).sum(1)
    return ((words + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32).T


def decode(buckets, values: torch.Tensor, syndromes: torch.Tensor,
           first_fill: torch.Tensor, cfg: dict):
    """(words [F, n_words] int32, counts [F] int64, solved [F] bool) of the
    frames given as natural-order ``values`` [n_vars, F] and ``syndromes``
    [n_checks, F] int8 on one device; ``first_fill`` [F] bool marks the
    frames decoded from the start of a call (the others refill a lane).
    ``cfg`` is the configuration: channel, noise, check_period,
    first_check, max_iterations, phi_floor."""
    k, cap = cfg["check_period"], cfg["max_iterations"]
    first_point = max(cfg["first_check"], k)
    floor = cfg["phi_floor"]
    dev = values.device
    f = values.shape[1]
    llr = channel_llr(values, cfg["channel"], cfg["noise"])
    syn = syndromes.to(torch.int64)
    q = llr.index_select(0, buckets.edge_var)  # variable-to-check
    r = torch.empty_like(q)                    # check-to-variable
    wash = (~first_fill).to(torch.int64)
    counts = torch.zeros(f, dtype=torch.int64, device=dev)
    done = torch.zeros(f, dtype=torch.bool, device=dev)
    solved = torch.zeros(f, dtype=torch.bool, device=dev)
    words = None
    t = 0
    while not bool(done.all()):
        t += 1
        for nodes, edges in buckets.checks:
            m = q[edges]                         # [n, d, F]
            neg = torch.signbit(m)
            a = phi(m.abs(), floor)
            odd = (neg.sum(1, keepdim=True, dtype=torch.int64)
                   + edges.shape[1] + syn[nodes][:, None, :]) & 1
            mag = phi(a.sum(1, keepdim=True) - a, floor)
            r[edges] = torch.where((odd != 0) ^ neg, -mag, mag)
            del m, neg, a, odd, mag
        total = llr.clone()
        for nodes, edges in buckets.vars:
            w = r[edges]                         # [m, d, F]
            tv = llr[nodes] + w.sum(1)
            q[edges] = tv[:, None, :] - w
            total[nodes] = tv
            del w, tv
        count = t + wash
        point = torch.where(first_fill, (count >= first_point)
                            & ((count - first_point) % k == 0),
                            (count >= k) & (count % k == 0)) & ~done
        if not bool(point.any()):
            continue
        bits = (~torch.signbit(total)).to(torch.int8)
        violated = (buckets.syndromes(bits) != syndromes).any(0)
        retire = point & (~violated | (count >= cap))
        if bool(retire.any()):
            idx = torch.nonzero(retire).flatten()
            packed = pack(bits[:, idx])
            if words is None:
                words = torch.zeros((f, packed.shape[1]), dtype=torch.int32,
                                    device=dev)
            words[idx] = packed
            counts[idx] = count[idx]
            solved |= retire & ~violated
            done |= retire
    return words, counts, solved
