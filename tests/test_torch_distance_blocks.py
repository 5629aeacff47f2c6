"""The port's dense plain Hamming distances in blocks of rows, against the
JAX package's ``distance_matrix`` and a numpy bit count, on the CPU.

``ops.hamming.distance_matrix`` (also behind K3's plain version) counts
bits in int32 word by word, on the CPU in blocks of rows of about
``_CPU_BLOCK`` pairs.  The shapes put block edges inside
the matrix, leave a ragged last block, give blocks of one row (N above the
block), and broadcast leading dims as K3 does; descriptors hold every
32-bit pattern class (all ones, the sign bit alone, zeros).  Exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ydorbslam_tpu.ops import hamming as jhamming

from ydorbslam_tpu_torch.ops import hamming


def _words(rng, shape):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[:3] = [0xFFFFFFFF, 0x80000000, 0]
    return w.view(np.int32)


_BITS = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(axis=1)


def _reference(a, b):
    """Bit counts of the XORed words' bytes from a 256-entry table, summed
    per pair."""
    x = np.bitwise_xor(a[..., :, None, :], b[..., None, :, :]).view(np.uint8)
    return _BITS[x].sum(axis=-1).astype(np.int32)


@pytest.mark.parametrize("M, N", [(1, 1), (300, 1000), (257, 1024), (3, (1 << 18) + 5)])
def test_distance_matrix_in_blocks_is_exact(M, N):
    rng = np.random.default_rng(M + N)
    a, b = _words(rng, (M, 8)), _words(rng, (N, 8))
    got = hamming.distance_matrix(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhamming.distance_matrix(
        jnp.asarray(a.view(np.uint32)), jnp.asarray(b.view(np.uint32)))))
    if M * N <= 300_000:
        np.testing.assert_array_equal(got.numpy(), _reference(a, b))


@pytest.mark.parametrize("lead_a, lead_b", [((5,), (5,)), ((1,), (4,)), ((2, 3), (2, 3))])
def test_distance_matrix_broadcasts_leading_dims(lead_a, lead_b):
    rng = np.random.default_rng(len(lead_a) + lead_b[0])
    a, b = _words(rng, lead_a + (200, 8)), _words(rng, lead_b + (400, 8))
    got = hamming.distance_matrix(torch.from_numpy(a), torch.from_numpy(b))
    lead = np.broadcast_shapes(lead_a, lead_b)
    assert got.shape == lead + (200, 400)
    np.testing.assert_array_equal(got.numpy(), _reference(a, b))
