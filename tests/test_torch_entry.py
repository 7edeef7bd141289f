"""The port's entry point (``serf_tpu_torch.entry``) against the
reference's ``__graft_entry__.entry()``: the same flagship config, the
same seeded cluster with the same injected fact, and one
``cluster_round`` from the same key.  Every integer leaf is bit-exact
before and after the round; Vivaldi's float leaves within rtol 1e-4,
atol 1e-5 (``test_torch_cluster``).  The reference's entry is fixed at
N = 16384; here both run at N = 1024 (the reference's through its own
``entry()``, with ``flagship_config`` asked for 1024 nodes)."""

import pathlib

import jax
import pytest
import torch

import __graft_entry__ as graft
import serf_tpu.models.swim as jswim
from serf_tpu_torch import convert, entry
from test_torch_cluster import _leaves, _mismatches

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores (the port's tests ran 3.6x slower so)
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N_ENTRY = 1024


@pytest.fixture(scope="module")
def both(request):
    flagship = jswim.flagship_config
    mp = pytest.MonkeyPatch()
    mp.setattr(jswim, "flagship_config",
               lambda n, **kw: flagship(N_ENTRY, **kw))
    try:
        jfn, jargs = graft.entry()
    finally:
        mp.undo()
    tfn, targs = entry.entry(N_ENTRY, device="cpu")
    return dict(j_args=jargs, t_args=targs,
                j_out=jax.block_until_ready(jfn(*jargs)),
                t_out=tfn(*targs))


def test_entry_args_match(both):
    jstate, jkey = both["j_args"]
    tstate, tkey = both["t_args"]
    assert jstate.gossip.known.shape[0] == N_ENTRY
    assert (jax.random.key_data(jkey).tolist() == tkey.tolist())
    assert _mismatches(_leaves(jstate), convert.to_numpy(tstate)) == []


def test_entry_round_matches(both):
    assert _mismatches(_leaves(both["j_out"]),
                       convert.to_numpy(both["t_out"])) == []
    assert int(both["t_out"].gossip.round) == 1


def test_entry_is_the_reference_flagship():
    """The default size is the reference entry's, and the round runs the
    array path (``use_pallas`` as ``flagship_config`` leaves it)."""
    src = (REPO / "__graft_entry__.py").read_text()
    assert f"flagship_config({entry.ENTRY_N})" in src
    from serf_tpu_torch.models.swim import flagship_config
    assert flagship_config(entry.ENTRY_N).gossip.use_pallas is False


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry(N_ENTRY)
