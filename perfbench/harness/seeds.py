"""Seeds drawn from ``--seed``: one per purpose, so that the weights and the
token ids do not share draws."""

from __future__ import annotations

import numpy as np

# purposes of the streams
WEIGHTS, TOKENS = 1, 2


def derive(seed: int, purpose: int) -> int:
    """A 63-bit seed for ``purpose`` from any whole ``seed`` (negative or
    wider than 64 bits too)."""
    entropy = int(seed) % (1 << 128)
    state = np.random.SeedSequence(entropy, spawn_key=(purpose,))
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))

