"""The port's threefry twins (``serf_tpu_torch.prng``) against
``jax.random``, bit for bit: keys, split fan-outs, randint (including
spans that are not powers of two), uniform and bernoulli, on draws small
enough for the host path and large enough for the tensor path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serf_tpu_torch import prng

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

SEEDS = [0, 3, 12345, 2**32 - 5]
#: one draw on each side of the host/tensor threshold
SIZES = [7, prng.HOST_DRAW_MAX + 904]


def _kd(seed):
    return np.asarray(jax.random.key_data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches(seed):
    assert np.array_equal(prng.key(seed), _kd(seed))


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.key(2**32)
    with pytest.raises(ValueError):
        prng.key(-1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5, 7, 40])
def test_split_fanouts(seed, num):
    # 2: pick/k_org splits; 5: probe_round; 7: cluster_round; 40: the
    # per-round key split of a run
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), num)))
    assert np.array_equal(prng.split(_kd(seed), num), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((3,), 1, 1024),             # rotation offsets, power-of-two span + 1
    ((3,), 1, 1_000_000),        # flagship offsets
    ((2,), 0, 1_000_000),        # sustained-event origins
    ((1,), 1, 70_000),
    ((1000, 3), 0, 1000),        # iid peers
    ((SIZES[1],), 0, 12_345),    # tensor path, odd span
    ((5,), 0, 1),                # one-value span
])
def test_randint(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi,
                                         dtype=jnp.int32))
    got = prng.randint(_kd(seed), shape, lo, hi, "cpu").numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(SIZES[0],), (SIZES[1],), (33, 8),
                                   (1024, 3)])
def test_uniform(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
    got = prng.uniform(_kd(seed), shape, "cpu").numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.0, 0.3, 0.5])
@pytest.mark.parametrize("shape", [(SIZES[0],), (SIZES[1],), (512, 3)])
def test_bernoulli(seed, p, shape):
    want = np.asarray(jax.random.bernoulli(jax.random.key(seed), p, shape))
    got = prng.bernoulli(_kd(seed), p, shape, "cpu").numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS + [7, 8, 9, 10])
def test_bernoulli_scalar(seed):
    # pick_bounded's layout coin
    assert prng.bernoulli(_kd(seed)) == bool(
        jax.random.bernoulli(jax.random.key(seed)))
