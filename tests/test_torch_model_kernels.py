"""The plain versions of the port's two model kernels against the reference.

Each plain PyTorch version (repro_torch/kernels/ref.py: what the port runs
on the CPU and what the card's kernels are held to) meets the reference
package's Pallas kernel in interpret mode on the same numpy inputs, at the
shapes of tests/test_kernels.py:

  * `ssd_intra_chunk`: rtol / atol 1e-4 (the reference's own tolerance
    between its kernel and its segsum path);
  * `flash_attention`: 2e-5 in f32, 2e-2 in bf16 (one bf16 rounding of
    outputs of order 1);
  * the sequential SSD oracle `ssd_chunk`: 1e-5 against the reference's.

tests/test_torch_card.py and chip_smoke.py hold each hand-written kernel to
its plain version on the card.  The shape choices the kernels' wrappers make
in Python (the SSD kernel's slab of heads per block, the flash kernel's
padded head dim) are checked here, on the CPU.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attention as j_flash
from repro.kernels.ssd_chunk import ssd_intra_chunk as j_ssd_intra
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
T = torch.tensor

SSD_SHAPES = [(1, 2, 16, 4, 8, 1, 8), (2, 4, 32, 8, 16, 2, 16),
              (1, 1, 64, 16, 32, 4, 32)]
FLASH_SHAPES = [
    # (b, sq, sk, h, kv, d, causal, bq, bk): the reference's block sizes
    (2, 64, 64, 4, 2, 16, True, 16, 16),
    (1, 128, 128, 8, 8, 32, True, 32, 64),
    (2, 32, 96, 4, 1, 16, False, 16, 32),   # MQA cross-attention shape
    (1, 48, 48, 2, 2, 8, True, 48, 16),
]


def _ssd_inputs(shape, seed):
    bt, nc, q, h, p, g, n = shape
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((bt, nc, q, h, p)).astype(np.float32) * 0.3
    da = -np.abs(rng.standard_normal((bt, nc, h, q)).astype(np.float32)) * 0.2
    bmat = rng.standard_normal((bt, nc, q, g, n)).astype(np.float32) * 0.3
    cmat = rng.standard_normal((bt, nc, q, g, n)).astype(np.float32) * 0.3
    return xdt, da, bmat, cmat


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_chunk_plain_matches_pallas(shape):
    """The reference kernel takes B and C repeated per head; the port's
    takes them per group.  Both forms of the port agree with it."""
    xdt, da, bmat, cmat = _ssd_inputs(shape, sum(shape))
    h, g = shape[3], shape[5]
    bh, ch = (np.repeat(m, h // g, axis=3) for m in (bmat, cmat))
    want = np.asarray(j_ssd_intra(xdt, da, bh, ch, interpret=True))
    for b_, c_ in ((bmat, cmat), (bh, ch)):
        got = ops.ssd_intra_chunk(T(xdt), T(da), T(b_), T(c_))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ssd_intra_chunk_masked_entries_are_zero():
    """A position's output depends on no later position (exact zeros, not
    exp of a large negative number)."""
    xdt, da, bmat, cmat = _ssd_inputs((1, 1, 16, 2, 4, 1, 8), 5)
    base = ops.ssd_intra_chunk(T(xdt), T(da), T(bmat), T(cmat))
    xdt[:, :, 9:] = 1e30
    got = ops.ssd_intra_chunk(T(xdt), T(da), T(bmat), T(cmat))
    np.testing.assert_array_equal(got[:, :, :9].numpy(),
                                  base[:, :, :9].numpy())


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_plain_matches_pallas(shape):
    b, sq, sk, h, kv, d, causal, bq, bk = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    want = np.asarray(j_flash(q, k, v, scale=0.35, causal=causal, block_q=bq,
                              block_k=bk, interpret=True))
    got = ops.flash_attention(T(q), T(k), T(v), scale=0.35, causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_plain_matches_pallas_bf16():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(ml_dtypes.bfloat16)
               for s in ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.25, block_q=16, block_k=16,
                              interpret=True), np.float32)
    bf = [torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
          for x in (q, k, v)]
    got = ops.flash_attention(*bf, scale=0.25, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("sq,sk", [(48, 80), (80, 48), (33, 33)])
def test_flash_attention_causal_ragged_matches_sdpa(sq, sk):
    """Causal with Sq != Sk (top-left: column <= row) and lengths that are
    no multiple of any block: the reference's `layers.sdpa` with
    `causal_mask(sq, sk)` decides."""
    from repro.models import layers as JL
    rng = np.random.default_rng(sq * sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    want = np.asarray(JL.sdpa(q, k, v, JL.causal_mask(sq, sk), 0.25))
    got = ops.flash_attention(T(q), T(k), T(v), scale=0.25, causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ssd_chunk_oracle_matches_reference():
    rng = np.random.default_rng(3)
    t, h, p, g, n = 40, 4, 8, 2, 16
    x = rng.standard_normal((t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((t, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    b = (rng.standard_normal((t, g, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((t, g, n)) * 0.3).astype(np.float32)
    want = np.asarray(jref.ssd_chunk(x, dt, a, b, c))
    got = ref.ssd_chunk(T(x), T(dt), T(a), T(b), T(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_model_kernels_take_the_plain_path_on_the_cpu():
    """CPU tensors count no launch; no switch reroutes the card."""
    ops.reset_launch_counts()
    xdt, da, bmat, cmat = _ssd_inputs(SSD_SHAPES[0], 0)
    ops.ssd_intra_chunk(T(xdt), T(da), T(bmat), T(cmat))
    q = torch.zeros((1, 8, 2, 8))
    ops.flash_attention(q, q, q, scale=1.0)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("rows,groups,rep,want", [
    (32, 2, 56, 8),     # zamba2-7b, 2 x 4096 tokens: 448 blocks
    (32, 1, 80, 8),     # mamba2-2.7b: 320 blocks
    (4, 2, 56, 1),      # 1 x 1024 tokens: no slab fills 264 blocks
    (16, 2, 56, 6),     # 16 x 2 x 10 = 320 >= 264; R = 7 gives 256
    (1000, 1, 3, 3),    # never more than a group holds
    (1, 1, 1, 1)])
def test_ssd_slab_heads(rows, groups, rep, want):
    from repro_torch.kernels.ssd_chunk import MAX_SLAB, slab_heads
    r = slab_heads(rows, groups, rep)
    assert r == want

    def blocks(x):
        return rows * groups * -(-rep // x)
    # the most heads, up to MAX_SLAB, that still give 132 SMs two blocks
    assert 1 <= r <= min(MAX_SLAB, rep)
    assert r == 1 or blocks(r) >= 2 * 132
    assert r == min(MAX_SLAB, rep) or blocks(r + 1) < 2 * 132


@pytest.mark.parametrize("d,want", [(8, (8, 16)), (16, (16, 16)),
                                    (36, (40, 48)), (64, (64, 64)),
                                    (112, (112, 112)), (120, (120, 128)),
                                    (250, (256, 256)), (256, (256, 256))])
def test_flash_padded_head_dim(d, want):
    """The bf16 kernel reads rows of d8 (a multiple of 8: 16-byte copies)
    and tiles dp (a multiple of 16: wgmma's reduction depth) columns;
    zamba2's 112 needs no padding at all."""
    from repro_torch.kernels.flash_attn import padded_head_dim
    d8, dp = padded_head_dim(d)
    assert (d8, dp) == want
    assert d8 % 8 == 0 and d <= d8 < d + 8
    assert dp % 16 == 0 and d8 <= dp < d + 16
