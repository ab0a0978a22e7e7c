"""Sharded, deterministic, resumable data pipeline (port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard): a restart at step
k reproduces exactly the batches a run without the failure would have
seen, and any shard layout reconstructs the same global batch (elastic
re-sharding).  The token stream is made lazily in fixed-size chunks, so
a long run holds O(chunk) host memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from .synthetic import make_token_stream


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    chunk_tokens: int = 1 << 20  # stream regeneration granularity


class TokenPipeline:
    """Iterator over LM batches (numpy int32 ``tokens``/``labels``) with
    explicit integer state.

    ``shard_id``/``num_shards`` split the *global* batch across the
    data-parallel ranks: the shards see disjoint rows of the same global
    batch.
    """

    def __init__(self, cfg: PipelineConfig, shard_id: int = 0,
                 num_shards: int = 1, step: int = 0):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.step = step
        self._chunk_idx: Optional[int] = None
        self._chunk: Optional[np.ndarray] = None

    def _tokens_for(self, chunk_idx: int) -> np.ndarray:
        if self._chunk_idx != chunk_idx:
            self._chunk = make_token_stream(
                self.cfg.chunk_tokens, self.cfg.vocab,
                seed=self.cfg.seed * 100003 + chunk_idx)
            self._chunk_idx = chunk_idx
        return self._chunk

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """This shard's (inputs, labels) rows of global step ``step``."""
        c = self.cfg
        rows_per_shard = c.global_batch // self.num_shards
        span = c.seq_len + 1
        tokens_per_step = c.global_batch * span
        steps_per_chunk = max(1, c.chunk_tokens // tokens_per_step)
        chunk = self._tokens_for(step // steps_per_chunk)
        off = (step % steps_per_chunk) * tokens_per_step
        window = chunk[off:off + tokens_per_step].reshape(c.global_batch,
                                                          span)
        rows = window[self.shard_id * rows_per_shard:
                      (self.shard_id + 1) * rows_per_shard]
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: PipelineConfig, state: dict, shard_id: int = 0,
                num_shards: int = 1) -> "TokenPipeline":
        if state["seed"] != cfg.seed:
            raise ValueError("seed mismatch on resume")
        return cls(cfg, shard_id=shard_id, num_shards=num_shards,
                   step=state["step"])
