"""Deterministic, stateless-resumable synthetic LM data (port of
``repro.data.pipeline``, in numpy as there).

Batch t is a pure function of (seed, t): a restart after a failure needs
no loader state (the trainer asks for step t again).  Tokens follow a
noisy affine-recurrence Markov chain, so models can reduce their loss in
integration tests; a 5% padding mask mimics packed documents.  Batch t
is bit-equal to the reference's for every (seed, t).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass
class SyntheticLMData:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_p: float = 0.75

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed + 7919 * step))
        B, S, V = self.global_batch, self.seq_len, self.cfg.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.integers(0, V, (B, S))
        use_chain = rng.random((B, S)) < self.markov_p
        for s in range(S):
            nxt = (toks[:, s] * 31 + 7) % V
            toks[:, s + 1] = np.where(use_chain[:, s], nxt, noise[:, s])
        # document boundaries -> loss mask (mask out 5% as padding)
        mask = (rng.random((B, S)) > 0.05).astype(np.float32)
        out = {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].astype(np.int32),
            "mask": mask,
        }
        if self.cfg.frontend == "vision":
            out["image_embeds"] = rng.standard_normal(
                (B, self.cfg.frontend_tokens, self.cfg.d_model),
                dtype=np.float32).astype(np.float32)
        if self.cfg.encoder_layers:
            out["enc_frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model), dtype=np.float32)
        return out
