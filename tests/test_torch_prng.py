"""The port's threefry stream (``repro_torch.prng``) against ``jax.random``:
keys, ``split``, raw bits, ``uniform``, ``randint`` and ``bernoulli``
bit for bit, ``gumbel`` to the last ulp of the two libraries' ``log``,
and batched keys equal to drawing key by key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

torch.set_num_threads(1)  # the test workers share the host's cores

SEEDS = [0, 5, 1234, 2**33 + 7]


def jkey(seed):
    return jax.random.PRNGKey(seed)


def as64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    if seed >= 2**32:  # jax needs x64 for a 64-bit seed; the word split is by definition
        assert prng.PRNGKey(seed, device="cpu").tolist() == [seed >> 32, seed & 0xFFFFFFFF]
        return
    k, t = jkey(seed), prng.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(as64(k), t.numpy())
    for data in (0, 3, 7, 2**31 + 5):
        np.testing.assert_array_equal(as64(jax.random.fold_in(k, data)),
                                      prng.fold_in(t, data).numpy())
    kk = jax.random.fold_in(jax.random.fold_in(k, 3), 7)
    tt = prng.fold_in(prng.fold_in(t, 3), 7)
    np.testing.assert_array_equal(as64(kk), tt.numpy())
    for n in (1, 2, 3, 8):
        np.testing.assert_array_equal(as64(jax.random.split(kk, n)), prng.split(tt, n).numpy())


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4), (2, 3, 5), (70_000,)])
def test_bits_and_uniform(shape):
    k, t = jkey(11), prng.PRNGKey(11, device="cpu")
    np.testing.assert_array_equal(as64(jax.random.bits(k, shape)), prng.bits(t, shape).numpy())
    u = prng.uniform(t, shape)
    assert u.dtype == torch.float32 and tuple(u.shape) == shape
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, shape)), u.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0)),
        prng.uniform(t, shape, minval=-2.0, maxval=3.0).numpy())


def test_gumbel_to_the_ulp():
    k, t = jkey(5), prng.PRNGKey(5, device="cpu")
    want = np.asarray(jax.random.gumbel(k, (50_000,)))
    got = prng.gumbel(t, (50_000,)).numpy()
    # the bits are equal; only the two libraries' log may differ by an ulp
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=2e-7)


@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 32768), (0, 50_000), (-5, 7), (0, 100_000),
                                   (3, 3), (10, 2), (-(2**31), 2**31 - 1)])
def test_randint(lo, hi):
    k, t = jkey(9), prng.PRNGKey(9, device="cpu")
    want = as64(jax.random.randint(k, (4, 257), lo, hi))
    got = prng.randint(t, (4, 257), lo, hi)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
def test_bernoulli(p):
    k, t = jkey(3), prng.PRNGKey(3, device="cpu")
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(k, p, (16, 9))),
                                  prng.bernoulli(t, p, (16, 9)).numpy())


def test_batched_keys_draw_as_one_key_each():
    """Leading key axes broadcast: a (B, 2) key batch draws what each key
    draws alone (the sampler's vectorised rows)."""
    base = prng.PRNGKey(5, device="cpu")
    streams, steps = torch.tensor([0, 1, 7]), torch.tensor([4, 0, 2])
    keys = prng.fold_in(prng.fold_in(base, streams), steps)
    assert keys.shape == (3, 2)
    g = prng.gumbel(keys, (300,))
    b = prng.bits(keys, (2, 150))
    for i in range(3):
        jk = jax.random.fold_in(jax.random.fold_in(jkey(5), int(streams[i])), int(steps[i]))
        np.testing.assert_array_equal(as64(jk), keys[i].numpy())
        np.testing.assert_array_equal(as64(jax.random.bits(jk, (2, 150))), b[i].numpy())
        np.testing.assert_allclose(g[i].numpy(), np.asarray(jax.random.gumbel(jk, (300,))),
                                   rtol=3e-7, atol=2e-7)
    split = prng.split(keys, 4)
    assert split.shape == (3, 4, 2)
    np.testing.assert_array_equal(split[1].numpy(), prng.split(keys[1], 4).numpy())


def test_chunked_bits_span_chunks():
    """A draw larger than one chunk of the counter equals JAX's draw."""
    k, t = jkey(21), prng.PRNGKey(21, device="cpu")
    n = (1 << 18) + 123
    np.testing.assert_array_equal(as64(jax.random.bits(k, (n,))), prng.bits(t, (n,)).numpy())


def test_key_shape_is_checked():
    with pytest.raises(ValueError, match="trailing axis"):
        prng.bits(torch.zeros(3, dtype=torch.int64), (4,))
    with pytest.raises(ValueError, match="non-negative"):
        prng.PRNGKey(-1, device="cpu")
    assert jnp.asarray(0).dtype == jnp.int32  # the reference runs without x64
