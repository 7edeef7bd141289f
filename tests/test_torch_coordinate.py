"""The port's coordinate client (``serf_tpu_torch.host.coordinate``)
against the reference's, the port's host oracle in ``vivaldi_ab``
against the reference tool's, and the port's device Vivaldi against the
port's coordinate client.

The client is the same float64 Python in both packages: with the same
``random.Random`` seeds and the same observations the coordinates are
equal, not close.  The reference tool's oracle gives each client an
unseeded ``random.Random``; the test hands its clients the port's
seeded generators (:func:`seeded_reference_clients`), and then the two
oracles agree exactly.  ``models/vivaldi.vivaldi_update`` (float32
tensors) follows ``CoordinateClient`` (filter 1) step for step at the
reference test's tolerances (``tests/test_device_plane.py:175-230``):
``chip_smoke.vivaldi_vs_host`` runs that comparison, here on the CPU
and on the card in phase 6.
"""

import contextlib
import importlib.util
import math
import pathlib
import random
import sys

import pytest
import torch

import chip_smoke as cs
from serf_tpu.host import coordinate as rcoord
from serf_tpu_torch.host import coordinate as tcoord
from serf_tpu_torch.tools import vivaldi_ab as tvab

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores, and a full-width intra-op pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def reference_tool(name: str):
    """A reference command line loaded from its file (``tools/``)."""
    mod = sys.modules.get(f"_ref_tool_{name}")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"_ref_tool_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def seeded_reference_clients(seed: int):
    """While open, the reference's ``CoordinateClient()`` built without
    a generator takes ``vivaldi_ab.client_rng(seed, i)``, ``i`` counting
    the clients built, as the port's oracle gives them."""
    base = rcoord.CoordinateClient
    count = iter(range(1 << 62))

    class Seeded(base):
        def __init__(self, opts=None, rng=None):
            super().__init__(opts, rng or tvab.client_rng(seed, next(count)))

    rcoord.CoordinateClient = Seeded
    try:
        yield
    finally:
        rcoord.CoordinateClient = base


def _coord_tuple(c):
    return (tuple(c.portion), c.error, c.adjustment, c.height)


@pytest.mark.parametrize("filt", [1, 3])
def test_client_equal_over_updates(filt):
    """Eight clients each, fed the same observations (coincident starts
    included, so the seeded separation draws run), stay equal."""
    rng = random.Random(filt)
    ref = [rcoord.CoordinateClient(rcoord.CoordinateOptions(
        latency_filter_size=filt), rng=random.Random(i)) for i in range(8)]
    ours = [tcoord.CoordinateClient(tcoord.CoordinateOptions(
        latency_filter_size=filt), rng=random.Random(i)) for i in range(8)]
    for _ in range(400):
        i, j = rng.randrange(8), rng.randrange(8)
        rtt = rng.choice([0.004, 0.02, 0.3]) * (0.5 + rng.random())
        a = ref[i].update(f"n{j}", ref[j].get_coordinate(), rtt)
        b = ours[i].update(f"n{j}", tcoord.Coordinate(
            *_coord_tuple(ours[j].get_coordinate())), rtt)
        assert _coord_tuple(b) == _coord_tuple(a)
    for r, o in zip(ref, ours):
        assert o.stats() == r.stats()
        assert o.get_coordinate().encode() == r.get_coordinate().encode()
        assert _coord_tuple(tcoord.Coordinate.decode(
            r.get_coordinate().encode())) == _coord_tuple(r.get_coordinate())


def test_client_rejects_alike():
    for mod in (rcoord, tcoord):
        c = mod.CoordinateClient(rng=random.Random(0))
        for rtt in (0.0, -1.0, 11.0):
            with pytest.raises(ValueError):
                c.update("x", mod.Coordinate.new(mod.CoordinateOptions()),
                         rtt)
        with pytest.raises(ValueError):
            c.update("x", mod.Coordinate(portion=(0.0,) * 3), 0.1)
        with pytest.raises(ValueError):
            c.set_coordinate(mod.Coordinate(
                portion=(math.nan,) * 8))
        c.update("x", mod.Coordinate.new(mod.CoordinateOptions()), 0.1)
        c.forget_node("x")
        assert c.latency_filters == {}


@pytest.mark.parametrize("spike_p", [0.0, 0.05])
def test_host_oracle_equals_reference(spike_p):
    ref = reference_tool("vivaldi_ab")
    with seeded_reference_clients(0):
        want = ref.host_oracle_run(32, 20, spike_p)
    assert tvab.host_oracle_run(32, 20, spike_p) == want


@pytest.mark.parametrize("n,steps,random_starts", [(4, 25, False),
                                                    (64, 25, True)])
def test_device_vivaldi_follows_the_client(n, steps, random_starts):
    """The port's ``vivaldi_update`` on the CPU against the port's
    ``CoordinateClient`` (filter 1), step for step from distinct starts,
    within the reference test's tolerances (phase 6 runs it on the card
    at n = 4 and n = 1024)."""
    out = cs.vivaldi_vs_host(n, steps, "cpu", random_starts)
    assert (out["n"], out["steps"]) == (n, steps)
    assert 0.0 <= out["worst_tol_ratio"] <= 1.0


def test_vivaldi_ab_host_rows_checked_against_the_reference():
    """Phase 5 holds ``vivaldi_ab``'s host rows to the reference oracle
    on the same seeded clients, to the printed digits."""
    host = {"clean_perpeer_n192": 0.14902, "spiky_perpeer_n192": 1.11276}
    fx = {"vivaldi_host": host}
    rows = ["host  n=192 clean per-peer filter: mean rel err 0.1490",
            "host  n=192 spiky per-peer filter: mean rel err 1.1128"]
    assert cs.vivaldi_host_differ(rows, fx) == []
    assert cs.vivaldi_host_differ([rows[0]], fx)
    assert cs.vivaldi_host_differ(
        [rows[0], rows[1].replace("1.1128", "1.1404")], fx)
