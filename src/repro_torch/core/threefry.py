"""Threefry-2x32 random bits, bit for bit with JAX's partitionable threefry.

The reference draws its failure and workload randomness through
`jax.random` with `jax_threefry_partitionable=True` (the default from JAX
0.5 on; checked against JAX 0.9.0).  This module reproduces those draws:

  * a key is two uint32 words; `prng_key(seed)` is `(0, seed)`, the low word
    the seed's 32-bit two's complement (so `prng_key(-1)` is
    `(0, 0xFFFFFFFF)`);
  * `fold_in(k, d)` is `threefry(k, (0, d))`;
  * `split(k, n)` is `threefry(k, (0, i))` for i < n, row i the new key
    `(x0[i], x1[i])`;
  * `random_bits(k, n)` is `x0 ^ x1` over the counters `(hi(i), lo(i))` of
    a 64-bit iota, i < n (`iota_2x32_shape`);
  * `uniform` puts the top 23 bits under the exponent of 1.0 and subtracts
    1; `bernoulli(k, p, shape)` is `uniform(k, shape) < p`.

Keys are int64 tensors of shape [..., 2] holding uint32 words (PyTorch's
uint32 has no addition or shifts on the CPU), so every function takes a
leading row axis: B seeds draw at once.  The 32-bit arithmetic runs in
int64 masked with 0xFFFFFFFF.  `threefry2x32` itself also takes numpy
uint32 arrays and Python integers; `split_chain` uses them to walk a key
chain on the host.  Plain PyTorch, no kernel: the reference draws
these bits through XLA, not through a Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000  # the bits of 1.0f


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1); returns the two output words.  Inputs broadcast:
    int64 tensors holding uint32 words, numpy uint32 arrays or Python
    integers."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(key: torch.Tensor):
    """The key's two words, each [..., 1] to meet a trailing counter axis."""
    return key[..., 0:1], key[..., 1:2]


def prng_key(seed, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: [2], or [B, 2] for a
    sequence, array or tensor of B seeds.  The words are made on the host
    and copied without waiting for the device (a run's step loop never
    waits for the card)."""
    s = torch.from_numpy(_seeds(seed.cpu().numpy()
                                if isinstance(seed, torch.Tensor) else seed))
    return torch.stack([torch.zeros_like(s), s & MASK], -1).to(
        device, non_blocking=True)


def _seeds(seed) -> np.ndarray:
    """Seeds as int64, refused unless each is a 32-bit integer."""
    s = np.asarray(seed)
    if s.dtype.kind not in "iu" or ((s < -2 ** 31) | (s >= 2 ** 31)).any():
        raise ValueError(f"a PRNG seed is a 32-bit integer, got {seed!r}")
    return s.astype(np.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for a 32-bit `data`."""
    k0, k1 = key[..., 0], key[..., 1]
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(k0),
                          torch.full_like(k1, int(data) & MASK))
    return torch.stack([x0, x1], -1)


def _counters(n: int, device):
    """The 64-bit iota 0..n-1 as (high word, low word), each [n]."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [..., num, 2]."""
    hi, lo = _counters(num, key.device)
    x0, x1 = threefry2x32(*_words(key), hi, lo)
    return torch.stack([x0, x1], -1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (32 bits): int64 [..., *shape] holding
    uint32 values, the counters running over `shape` in C order."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    x0, x1 = threefry2x32(*_words(key), *_counters(n, key.device))
    return (x0 ^ x1).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in f32 on [0, 1)."""
    bits = (random_bits(key, shape) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for an f32 `p` (a host number
    or a tensor that broadcasts against [..., *shape])."""
    p = p if isinstance(p, torch.Tensor) else np.float32(p)
    return uniform(key, shape) < p


def split_chain(seeds, n: int):
    """The key chain `rng, sub = split(rng)` walked `n` times from
    `prng_key(seeds)`, on the host in numpy: (keys uint32 [n + 1, B, 2],
    the key before each walk and after the last; subs uint32 [n, B, 2])."""
    s = _seeds(seeds).reshape(-1)
    keys = np.empty((n + 1, s.shape[0], 2), np.uint32)
    subs = np.empty((n, s.shape[0], 2), np.uint32)
    keys[0, :, 0], keys[0, :, 1] = 0, (s & MASK).astype(np.uint32)
    if s.shape[0] <= _INT_ROWS:
        # a few rows: Python integers (a numpy walk costs about as much
        # for one row as for 64, ~9 rows' worth of integer walks)
        for r in range(s.shape[0]):
            k0, k1 = 0, int(s[r]) & MASK
            for i in range(n):
                a0, a1 = threefry2x32(k0, k1, 0, 0)
                subs[i, r] = threefry2x32(k0, k1, 0, 1)
                keys[i + 1, r] = k0, k1 = a0, a1
        return keys, subs
    # split's two counters (0, 0) and (0, 1) as one [B, 2] call
    x0 = np.zeros((1, 2), np.uint32)
    x1 = np.array([[0, 1]], np.uint32)
    for i in range(n):
        y0, y1 = threefry2x32(keys[i, :, 0:1], keys[i, :, 1:2], x0, x1)
        keys[i + 1, :, 0], keys[i + 1, :, 1] = y0[:, 0], y1[:, 0]
        subs[i, :, 0], subs[i, :, 1] = y0[:, 1], y1[:, 1]
    return keys, subs


# rows up to which `split_chain` walks each row with Python integers
_INT_ROWS = 8
