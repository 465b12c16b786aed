"""Explicit random keys for the port's device draws.

A key has the layout of the reference's raw PRNG key: two uint32 words,
``key(seed) = [seed >> 32, seed & 0xFFFFFFFF]`` (the reference's
``PRNGKey(seed)`` for a non-negative seed), so a deployment spec or
npz records it in the same format.  The draws themselves come from
``torch.Generator``s seeded from the key's two words (``generator``):
they differ from the reference's threefry draws, and are held to it
statistically.  ``fold_in`` and ``split`` derive independent keys by
splitmix64 mixing, deterministically across processes, for one key or
an array of keys at once.

Many small devices (a fleet's chunk, a sweep's draws) draw from
counter-based streams instead (``stream_uniform``, ``stream_normal``):
element ``j`` of a key's stream is a hash of ``j`` and the key, computed
in tensors on the card for a whole batch of keys in a few launches, so a
device's draws do not depend on which others share its batch.
"""
from __future__ import annotations

import numpy as np
import torch

_M64 = (1 << 64) - 1


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over uint64 values (numpy's uint64
    arithmetic wraps): a bijection of 64-bit words whose output bits each
    depend on every input bit."""
    with np.errstate(over="ignore"):
        z = np.asarray(z, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


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


def _words(keys) -> np.ndarray:
    k = np.asarray(keys, np.uint32).astype(np.uint64)
    return (k[..., 0] << np.uint64(32)) | k[..., 1]


def _keys(w: np.ndarray) -> np.ndarray:
    return np.stack([(w >> np.uint64(32)).astype(np.uint32),
                     (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=-1)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """A key derived from ``k`` and an integer (a tag's crc32, a read
    cycle's ordinal, a device id); elementwise over keys (..., 2) and
    integer arrays that broadcast against each other."""
    d = np.asarray(data).astype(np.int64).astype(np.uint64)
    return _keys(_mix64(_words(k) ^ _mix64(d)))


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``n`` independent keys derived from ``k``: (n, 2), or (..., n, 2)
    for keys (..., 2)."""
    base = _mix64(_words(k) ^ np.uint64(0x5D1F7A3C2B4E6F01))
    with np.errstate(over="ignore"):
        return _keys(_mix64(base[..., None] + np.arange(n, dtype=np.uint64)))


def seed_of(k: np.ndarray) -> int:
    """The 64-bit generator seed of a key: both words mixed, so the low
    32 bits (all a CPU generator keeps) depend on both."""
    return int(_mix64(_words(as_key(k))))


# --------------------------------------------------------------------------- #
# Counter-based streams in tensors
# --------------------------------------------------------------------------- #
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for values below 2**32 held in int64 (a tensor
    or a numpy array), the constant split in 16-bit halves so no product
    leaves int64's range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit finalizer (xorshift-multiply, as Wellons' lowbias32): a
    bijection of [0, 2**32) whose output bits each depend on every input
    bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stream_keys(keys: np.ndarray) -> np.ndarray:
    """One int64 word in [0, 2**32) per key of ``keys`` (..., 2): what
    ``stream_uniform`` mixes each counter with."""
    k = np.asarray(keys, np.uint32).astype(np.int64)
    return _mix32(k[..., 0] ^ _mix32(k[..., 1] ^ 0x2545F491))


_COUNTERS: dict = {}


def _counters(n: int, device) -> torch.Tensor:
    """``_mix32`` of the counters 0..n-1 on ``device``, kept per (n,
    device): the key-independent half of every stream of length n."""
    dev = torch.device(device)
    ent = _COUNTERS.get((n, dev))
    if ent is None:
        ent = _mix32(torch.arange(n, dtype=torch.int64, device=dev))
        _COUNTERS[(n, dev)] = ent
    return ent


def stream_uniform(words: torch.Tensor, n: int) -> torch.Tensor:
    """(...) stream words (``stream_keys``, an int64 tensor) -> (..., n)
    float32 uniforms in (0, 1): element ``j`` of a word's row is
    ``_mix32(_mix32(j) ^ word)`` scaled, so each row depends only on its
    own word and ``j``.  Many words make one batch of launches."""
    h = _mix32(_counters(n, words.device) ^ words[..., None])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def stream_normal(words: torch.Tensor, n: int) -> torch.Tensor:
    """(...) stream words -> (..., n) float32 standard normals, by the
    inverse CDF of ``stream_uniform`` (tails cut near 5.4 sigma)."""
    h = _mix32(_counters(n, words.device) ^ words[..., None])
    v = (2 * (h >> 8) + (1 - (1 << 24))).float() * (1.0 / (1 << 24))
    return torch.erfinv(v) * 1.4142135623730951


def generator(k: np.ndarray, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the key."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(k))
    return g
