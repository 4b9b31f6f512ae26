"""Frames made from the seed on the card: data bits, channel values and
syndromes, in natural order.

One ``torch.Generator`` on the device, seeded with ``--seed``, draws every
block in turn, in a few large calls each, so the same seed gives the same
frames. A frame's data bits are uniform; a bit b is sent as 2b - 1 (the
program's convention: bit 1 is +1) through the configuration's channel, a
module ``channels/<name>.py`` found by name; the trailing punctured
variables get the value 0.0 (no channel value), as the program's pool
generator leaves them. The syndromes come from the alist (:class:`.graph.Buckets`),
so the data bits need not be a codeword.
"""

from __future__ import annotations

import numpy as np
import torch

from pbcore import cell
from pbcore.graph import Buckets, Graph


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_block(g: Graph, buckets: Buckets, channel: str, noise: float,
               n_frames: int, gen: torch.Generator, device):
    """(values [n_vars, n_frames] float32, syndromes [n_checks, n_frames]
    int8) on ``device``, drawn from ``gen``."""
    bits = torch.randint(0, 2, (g.n_vars, n_frames), generator=gen,
                         device=device, dtype=torch.int8)
    sent = bits.to(torch.float32).mul_(2.0).sub_(1.0)
    values = cell.channel(channel).values(sent, noise, gen)
    del sent
    if g.n_punctured:
        values[g.n_vars - g.n_punctured:] = 0.0
    return values, buckets.syndromes(bits)


def sample_frames(seed: int, n_bank: int, n_sample: int) -> np.ndarray:
    """The bank frames whose answers are checked, drawn from the seed,
    sorted."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    return np.sort(rng.choice(n_bank, size=min(n_sample, n_bank),
                              replace=False))
