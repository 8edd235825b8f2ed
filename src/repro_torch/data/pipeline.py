"""Deterministic sharded token pipeline.

A copy of the JAX package's ``data/pipeline.py`` ``TokenPipeline`` (it
holds no JAX, but the port imports nothing of that package): batch
content is a pure function of (seed, step, shard), so a restart
reproduces the stream and the cursor is just ``step``.  The corpus is
synthetic pseudo-text, a Markov-ish integer process the model can learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch_per_shard: int
    seq_len: int
    num_shards: int = 1
    shard_id: int = 0
    seed: int = 0

    def _example(self, index: int) -> np.ndarray:
        """Deterministic pseudo-text: token_{t+1} depends on token_t."""
        rng = np.random.default_rng((self.seed, index))
        v = self.vocab_size
        base = rng.integers(0, v, size=self.seq_len + 1, dtype=np.int64)
        # with p=0.7 the next token is a fixed affine function of the
        # previous one (learnable signal)
        follow = rng.random(self.seq_len + 1) < 0.7
        out = base.copy()
        for t in range(1, self.seq_len + 1):
            if follow[t]:
                out[t] = (out[t - 1] * 31 + 7) % v
        return out

    def get_batch(self, step: int) -> dict:
        """Returns {"tokens": [B, S], "targets": [B, S]} for this shard."""
        gb = self.batch_per_shard * self.num_shards
        idx0 = step * gb + self.shard_id * self.batch_per_shard
        ex = np.stack([self._example(idx0 + i)
                       for i in range(self.batch_per_shard)])
        return {"tokens": ex[:, :-1].astype(np.int32),
                "targets": ex[:, 1:].astype(np.int32)}

    # -- checkpoint contract -------------------------------------------------
    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.seed,
                "num_shards": self.num_shards}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])
