"""Token pipeline for the backbone training loop (deterministic, offline),
copied from the JAX package's ``data/lm_data.py`` (numpy only): the same
seed gives the same tokens.

Synthetic but *structured* token streams: a mixture of Zipf-distributed
unigrams and short repeated motifs, so a language model has learnable signal
and the loss visibly decreases over a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.35

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._motifs = rng.integers(
            0, self.vocab_size, size=(self.n_motifs, self.motif_len))

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, dtype=np.int32)
        i = 0
        while i < length:
            if rng.random() < self.motif_prob:
                m = self._motifs[rng.integers(0, self.n_motifs)]
                k = min(self.motif_len, length - i)
                out[i:i + k] = m[:k]
                i += k
            else:
                # zipf over the vocab (clipped)
                v = min(int(rng.zipf(self.zipf_a)) - 1, self.vocab_size - 1)
                out[i] = v
                i += 1
        return out


def synthetic_token_batches(
    vocab_size: int, batch: int, seq_len: int, *, seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens, targets) with targets = tokens shifted by one."""
    stream = TokenStream(vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        flat = stream.sample(rng, batch * (seq_len + 1))
        chunk = flat.reshape(batch, seq_len + 1)
        yield chunk[:, :-1].copy(), chunk[:, 1:].copy()
