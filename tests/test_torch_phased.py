"""The phased flavor of the port (``fused_kernels=False``: the standalone
``select_packets`` + ``merge_incoming`` family) against the reference,
leaf for leaf: the phased flagship over 48 sustained rounds, ``round_step``
in lockstep across stamp flavor x sendable cache, and N = 1001, where no
node block divides N, so both packages take the plain path.  The
reference's Pallas kernels run in interpret mode.  Integer leaves
bit-exact; Vivaldi f32 leaves within rtol 1e-4, atol 1e-5 (see
``test_torch_cluster``)."""

import jax
import numpy as np
import pytest

from serf_tpu.models import dissemination as jdis
from serf_tpu.models import swim as jswim
from serf_tpu_torch import convert, prng
from serf_tpu_torch.models import dissemination as tdis
from serf_tpu_torch.models import failure as tfail
from serf_tpu_torch.models import swim as tswim
from test_torch_cluster import (ATOL, EVENTS, ROUNDS, RTOL, _flagship,
                                _leaves, _mismatches, _paths, _seeded, _tcfg)
from test_torch_dissemination import _drive


@pytest.fixture(scope="module")
def phased_flagship():
    jcfg = _flagship(1024, fused_kernels=False)
    tcfg = _tcfg(jcfg)
    js, ts, ids = _seeded(jcfg, tcfg)
    jf = jswim.run_cluster_sustained(js, jcfg, jax.random.key(3), ROUNDS,
                                     events_per_round=EVENTS)
    tf = tswim.run_cluster_sustained(ts, tcfg, prng.key(3), ROUNDS,
                                     events_per_round=EVENTS)
    return dict(tcfg=tcfg, tf=tf, ids=ids, ref=_leaves(jf),
                port=convert.to_numpy(tf))


@pytest.mark.parametrize("path", _paths())
def test_phased_flagship_sustained_leaf(phased_flagship, path):
    x, y = phased_flagship["ref"][path], phased_flagship["port"][path]
    assert x.dtype == y.dtype and x.shape == y.shape
    if x.dtype.kind == "f":
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)
    else:
        assert np.array_equal(x, y), path


def test_phased_flagship_standalone_semantics(phased_flagship):
    """The standalone family ran: it clamps on every active round and
    invalidates the cache, and every seeded death was detected."""
    tcfg, tf = phased_flagship["tcfg"], phased_flagship["tf"]
    assert tdis.pallas_dispatch_mode(tcfg.gossip) == ("kernels", "")
    g = tf.gossip
    assert int(g.last_clamp) == ROUNDS
    assert int(g.sendable_round) == -1
    dead = tfail.believed_dead(g, tcfg.gossip, tcfg.failure).numpy()
    assert dead[phased_flagship["ids"]].all()


@pytest.mark.parametrize("peer_sampling", ["rotation", "iid"])
@pytest.mark.parametrize("use_sendable_cache", [True, False])
@pytest.mark.parametrize("pack_stamp", [True, False])
def test_standalone_round_step_lockstep(pack_stamp, use_sendable_cache,
                                        peer_sampling):
    cfg = jdis.GossipConfig(n=512, k_facts=64, pack_stamp=pack_stamp,
                            use_sendable_cache=use_sendable_cache,
                            use_pallas=True, fused_kernels=False,
                            peer_sampling=peer_sampling)
    assert jdis.pallas_dispatch_mode(cfg) == ("kernels", "")
    _, b = _drive(cfg)
    assert int(b.sendable_round) == -1


def test_ragged_n_takes_the_plain_path_on_both_sides():
    """N = 1001: no node block of 512..32 divides it, so the reference's
    ``pallas_ok`` refuses the standalone family and both packages run
    the plain round — which, unlike the kernels, keeps the cache and
    clamps only on learn rounds.  Every leaf matches over 24 rounds."""
    jcfg = _flagship(1001, fused_kernels=False)
    tcfg = _tcfg(jcfg)
    assert tdis.pallas_dispatch_mode(tcfg.gossip) == (
        "", "pallas_ok rejected shape")
    assert jdis.pallas_dispatch_mode(jcfg.gossip) == \
        tdis.pallas_dispatch_mode(tcfg.gossip)
    js, ts, _ = _seeded(jcfg, tcfg)
    jf = jswim.run_cluster_sustained(js, jcfg, jax.random.key(8), 24,
                                     events_per_round=EVENTS)
    tf = tswim.run_cluster_sustained(ts, tcfg, prng.key(8), 24,
                                     events_per_round=EVENTS)
    assert _mismatches(_leaves(jf), convert.to_numpy(tf)) == []
    assert int(tf.gossip.sendable_round) == 24
