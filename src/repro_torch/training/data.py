"""Synthetic sharded data pipeline.

Counterpart of `repro.training.data`: the same deterministic numpy stream
(seed + step -> batch), so a restart resumes exactly and the two packages
see the same batches. Emits next-token-prediction pairs: labels are
tokens shifted by one. `tokens` and `labels` are int64 tensors (torch
embeds with int64 ids; the values equal the reference's int32 ones);
`frames` and `patches` are bf16, rounded from the same float64 normals
(bit for bit the reference's `jnp.asarray(x, bfloat16)`).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticDataLoader:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 frames: int = 0, d_model: int = 0, patches: int = 0,
                 device="cpu"):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.frames, self.d_model, self.patches = frames, d_model, patches
        self.device = torch.device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # a compressible synthetic language: Zipfian unigrams + local repeat
        toks = rng.zipf(1.3, size=(self.batch, self.seq + 1)) % self.vocab
        rep = rng.random((self.batch, self.seq + 1)) < 0.3
        toks = np.where(rep, np.roll(toks, 1, axis=1), toks)
        toks = torch.from_numpy(toks.astype(np.int64))
        out = {"tokens": toks[:, :-1].contiguous().to(self.device),
               "labels": toks[:, 1:].contiguous().to(self.device)}
        if self.frames:
            out["frames"] = self._bf16(
                rng.normal(size=(self.batch, self.frames, self.d_model)))
        if self.patches:
            out["patches"] = self._bf16(
                rng.normal(size=(self.batch, self.patches, self.d_model)))
        return out

    def _bf16(self, x: np.ndarray) -> torch.Tensor:
        # float64 -> bfloat16 in one rounding, as jnp.asarray does
        return torch.from_numpy(x).to(torch.bfloat16).to(self.device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
