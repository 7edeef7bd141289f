"""Row-range draws (``prng``'s ``rows=``) against the global draw, for
every draw shape the placed round makes: a shard's rows of a draw are
the global draw's rows, bit for bit, whether the slice takes the host
path (at most ``HOST_DRAW_MAX`` values) or the tensor path, and whether
the global draw would.  The global draws are held against
``jax.random`` itself; ``randint_host`` (the rotation offsets a placed
round slices by) against ``randint``."""

import jax
import numpy as np
import pytest
import torch

from serf_tpu_torch import prng

torch.set_num_threads(1)

#: (what, draw, shape): the placed round's draws over the node axis
DRAWS = [
    ("pick scores", "uniform", (None,)),
    ("vivaldi unit vectors", "uniform", (None, 8)),
    ("probe drops", "bernoulli", (None,)),
    ("indirect probe drops", "bernoulli", (None, 3)),
    ("iid sources", "randint", (None, 3)),
    ("iid targets, partners, peers", "randint", (None,)),
    ("normal", "normal_uniform", (None, 2)),
]

#: N, and shard row ranges: a small slice of a draw past the host
#: threshold, a slice past it, the whole axis, an empty slice
N = prng.HOST_DRAW_MAX * 2 + 1000
RANGES = [(0, 5), (N // 4, N // 4 + 100), (N - 2500, N), (1000, N - 7),
          (0, N), (17, 17)]


def _draw(kind, k, shape, rows=None):
    if kind == "uniform":
        return prng.uniform(k, shape, "cpu", rows)
    if kind == "normal_uniform":
        return prng.normal_uniform(k, shape, "cpu", rows)
    if kind == "bernoulli":
        return prng.bernoulli(k, 0.3, shape, "cpu", rows)
    return prng.randint(k, shape, 0, N, "cpu", rows)


def _jax(kind, seed, shape):
    k = jax.random.key(seed)
    if kind == "uniform":
        return np.asarray(jax.random.uniform(k, shape))
    if kind == "normal_uniform":
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        return np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=1.0))
    if kind == "bernoulli":
        return np.asarray(jax.random.bernoulli(k, 0.3, shape))
    return np.asarray(jax.random.randint(k, shape, 0, N))


@pytest.mark.parametrize("what,kind,shape", DRAWS)
def test_row_ranges_are_the_global_draws_rows(what, kind, shape):
    seed = 7
    k = prng.key(seed)
    shape = (N,) + shape[1:]
    whole = _draw(kind, k, shape)
    assert np.array_equal(whole.numpy(), _jax(kind, seed, shape)), what
    for lo, hi in RANGES:
        part = _draw(kind, k, shape, rows=(lo, hi))
        assert part.shape == (hi - lo,) + shape[1:], what
        assert torch.equal(part, whole[lo:hi]), (what, lo, hi)


def test_small_draws_take_rows_too():
    """A draw under the host threshold, sliced: the same bits."""
    k = prng.key(3)
    whole = prng.randint(k, (64, 3), 0, 64, "cpu")
    for lo, hi in ((0, 16), (16, 32), (48, 64)):
        assert torch.equal(prng.randint(k, (64, 3), 0, 64, "cpu",
                                        rows=(lo, hi)), whole[lo:hi])


def test_row_range_outside_the_axis_raises():
    with pytest.raises(ValueError, match="outside axis 0"):
        prng.uniform(prng.key(0), (10,), "cpu", rows=(5, 11))
    with pytest.raises(ValueError, match="outside axis 0"):
        prng.uniform(prng.key(0), (10,), "cpu", rows=(6, 5))


@pytest.mark.parametrize("lo,hi", [(1, 1_000_000), (1, 1024), (0, 1000),
                                   (1, 250_000), (-3, 70_000)])
def test_randint_host_is_randint(lo, hi):
    for seed in (0, 5, 2**32 - 5):
        k = prng.key(seed)
        for shape in ((1,), (3,), (40, 3)):
            host = prng.randint_host(k, shape, lo, hi)
            assert host.dtype == np.int64
            assert np.array_equal(host, prng.randint(k, shape, lo, hi,
                                                     "cpu").numpy())
