"""Explicit random keys for the port's device draws.

A key has the layout of the reference's raw PRNG key: two uint32 words,
``key(seed) = [seed >> 32, seed & 0xFFFFFFFF]`` (the reference's
``PRNGKey(seed)`` for a non-negative seed), so a deployment spec or
npz records it in the same format.  The draws themselves come from
``torch.Generator``s seeded from the key's two words (``generator``):
they differ from the reference's threefry draws, and are held to it
statistically.  ``fold_in`` and ``split`` derive independent keys by
splitmix64 mixing, deterministically across processes.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words whose output
    bits each depend on every input bit."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def key(seed: int) -> np.ndarray:
    """A uint32[2] key from a non-negative integer seed."""
    s = int(seed) & _M64
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def as_key(k) -> np.ndarray:
    """An int seed, a ``torch.Generator`` (its seed) or two key words
    (list, numpy array, tensor) -> a uint32[2] key."""
    if isinstance(k, torch.Generator):
        return key(k.initial_seed())
    if isinstance(k, (int, np.integer)):
        return key(int(k))
    if isinstance(k, torch.Tensor):
        k = k.detach().cpu().numpy()
    a = np.asarray(k).astype(np.uint32).reshape(-1)
    if a.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {a.shape}")
    return a


def _word(k: np.ndarray) -> int:
    return (int(k[0]) << 32) | int(k[1])


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """A key derived from ``k`` and an integer (a tag's crc32, a read
    cycle's ordinal)."""
    return key(_mix64(_word(k) ^ _mix64(int(data) & _M64)))


def split(k: np.ndarray, n: int = 2) -> List[np.ndarray]:
    """``n`` independent keys derived from ``k``."""
    base = _mix64(_word(k) ^ 0x5D1F7A3C2B4E6F01)
    return [key(_mix64(base + i)) for i in range(n)]


def seed_of(k: np.ndarray) -> int:
    """The 64-bit generator seed of a key: both words mixed, so the low
    32 bits (all a CPU generator keeps) depend on both."""
    return _mix64(_word(k))


def generator(k: np.ndarray, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the key."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(k))
    return g
