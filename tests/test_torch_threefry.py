"""The port's threefry (repro_torch/core/threefry.py) against jax.random.

JAX 0.9.0's partitionable threefry on the CPU: keys, fold_in, split, raw
bits, uniforms and Bernoulli draws bit for bit for seeds 0, 3, 12345 and
-1 at 1, 977 and 192,817 elements, row by row for a batch of keys; the
Random123 known-answer vectors of threefry-2x32-20; the host key chain
`split_chain` on both of its paths; and the reference's f32 exponential
(`failures.exp_f32`), which decides the failure draws' thresholds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import failures, threefry

torch.set_num_threads(1)

SEEDS = (0, 3, 12345, -1)
SIZES = (1, 977, 192817)


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    pk = threefry.prng_key(seed)
    np.testing.assert_array_equal(pk.numpy(), _np(jk))
    for d in (0, 7, 101, 103, 2 ** 31):
        np.testing.assert_array_equal(threefry.fold_in(pk, d).numpy(),
                                      _np(jax.random.fold_in(jk, d)))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(threefry.split(pk, num).numpy(),
                                      _np(jax.random.split(jk, num)))


def test_negative_seed_is_its_twos_complement():
    np.testing.assert_array_equal(threefry.prng_key(-1).numpy(),
                                  [0, 0xFFFFFFFF])
    np.testing.assert_array_equal(threefry.prng_key(-2 ** 31).numpy(),
                                  _np(jax.random.PRNGKey(-2 ** 31)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed, n):
    jk = jax.random.PRNGKey(seed)
    pk = threefry.prng_key(seed)
    np.testing.assert_array_equal(threefry.random_bits(pk, n).numpy(),
                                  _np(jax.random.bits(jk, (n,))))
    np.testing.assert_array_equal(threefry.uniform(pk, n).numpy(),
                                  np.asarray(jax.random.uniform(jk, (n,))))
    for p in (0.0, 0.2, 0.5, 1.0):
        np.testing.assert_array_equal(
            threefry.bernoulli(pk, p, n).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, (n,))))


def test_draws_of_a_multi_dimensional_shape_match_jax():
    jk = jax.random.PRNGKey(9)
    pk = threefry.prng_key(9)
    np.testing.assert_array_equal(
        threefry.uniform(pk, (3, 5, 7)).numpy(),
        np.asarray(jax.random.uniform(jk, (3, 5, 7))))


def test_rows_draw_as_their_own_keys():
    """A batch of keys [B, 2] draws [B, n], row b as key b alone; a
    per-row probability broadcasts down the rows."""
    keys = threefry.prng_key(list(SEEDS))
    assert keys.shape == (len(SEEDS), 2)
    split = threefry.split(keys)
    sub = split[:, 1]
    u = threefry.uniform(sub, 977)
    p = torch.tensor([[0.1], [0.3], [0.6], [0.9]], dtype=torch.float32)
    draw = threefry.bernoulli(sub, p, 977)
    for b, seed in enumerate(SEEDS):
        _, jsub = jax.random.split(jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(split[b].numpy(),
                                      _np(jax.random.split(
                                          jax.random.PRNGKey(seed))))
        np.testing.assert_array_equal(u[b].numpy(), np.asarray(
            jax.random.uniform(jsub, (977,))))
        np.testing.assert_array_equal(draw[b].numpy(), np.asarray(
            jax.random.bernoulli(jsub, np.float32(p[b, 0]), (977,))))
        np.testing.assert_array_equal(
            threefry.fold_in(keys, 7)[b].numpy(),
            _np(jax.random.fold_in(jax.random.PRNGKey(seed), 7)))


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)),
])
def test_random123_known_answers(key, ctr, want):
    """threefry2x32_20 known-answer vectors (Random123 kat_vectors), on
    int64 tensors, numpy uint32 arrays and Python integers alike."""
    t = threefry.threefry2x32(*(torch.tensor(v) for v in (*key, *ctr)))
    assert tuple(int(x) for x in t) == want
    a = threefry.threefry2x32(*(np.array([v], np.uint32)
                                for v in (*key, *ctr)))
    assert tuple(int(x[0]) for x in a) == want
    assert threefry.threefry2x32(*key, *ctr) == want


@pytest.mark.parametrize("rows", [1, 3, 9])
def test_split_chain_matches_jax(rows):
    """The host chain `rng, sub = split(rng)` on both paths (Python
    integers up to 8 rows, numpy beyond)."""
    seeds = np.array(SEEDS * 3)[:rows]
    keys, subs = threefry.split_chain(seeds, 6)
    assert keys.shape == (7, rows, 2) and subs.shape == (6, rows, 2)
    for b, seed in enumerate(seeds):
        rng = jax.random.PRNGKey(int(seed))
        np.testing.assert_array_equal(keys[0, b], np.asarray(rng))
        for i in range(6):
            rng, sub = jax.random.split(rng)
            np.testing.assert_array_equal(keys[i + 1, b], np.asarray(rng))
            np.testing.assert_array_equal(subs[i, b], np.asarray(sub))


@pytest.mark.parametrize("seed", [2 ** 31, -2 ** 31 - 1, 1.5])
def test_seeds_outside_32_bits_are_refused(seed):
    with pytest.raises(ValueError, match="32-bit"):
        threefry.prng_key(seed)
    with pytest.raises((ValueError, TypeError)):
        threefry.split_chain([seed], 2)


@pytest.mark.parametrize("lo,hi", [(-1e-3, 0.0), (-2.0, 0.0), (-87.0, 87.0)])
def test_exp_matches_the_reference_bit_for_bit(lo, hi):
    """XLA's compiled CPU exp (the failure probabilities' exponential) on
    a million inputs of each range."""
    x = np.random.default_rng(int(-lo)).uniform(lo, hi, 1_000_000).astype(
        np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(failures.exp_f32(torch.from_numpy(x)
                                                   ).numpy(), want)


@pytest.mark.parametrize("hazard", [None, 0.0, 1.0, 2.5, [0.5, 1.5, 3.0]])
@pytest.mark.parametrize("mtbf", [1000.0, 30.0, 7.3])
def test_failure_probability_matches_the_reference(hazard, mtbf):
    """``1 - exp(-hazard * dt / mtbf)`` in the reference's f32 steps, as
    its eager ops compute it (what `step_host_failures` and
    `facility_failure_series` do outside a compiled program)."""
    dt = 0.25
    if hazard is None:
        want = 1.0 - jnp.exp(-dt / mtbf)
    else:
        want = 1.0 - jnp.exp(-jnp.asarray(hazard, jnp.float32) * (dt / mtbf))
    got = failures.failure_probability(hazard, dt, mtbf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
