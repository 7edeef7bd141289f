"""Each primitive of ``parallel.placed``'s group body against its
in-process body, over ``gloo`` on the CPU.

``W`` processes join one group, ``(W, L)`` = (2, 2) and (4, 1).  Every
rank makes the same global planes from one numpy seed, splits them into
the ``P = W * L`` shards' pieces, and calls each primitive twice: on
its own ``L`` pieces through the group layout (``Layout`` of the mesh
``make_hybrid_mesh`` gives inside the group) and on all ``P`` pieces
through the in-process layout of a placed mesh of ``P`` CPU shards.
The answers are equal bit for bit (a per-shard answer: the rank's
shards' part of the in-process answer), for int32, bool and float32
planes.  ``gather_state`` gives back the state every rank placed, and
``replicas_differ`` is ``[]`` until one rank's replicated leaf is
changed, then names that shard on every rank."""

import json

import pytest

from test_torch_host_scenarios import bounded, hard_limit
from test_torch_multiproc_round import spawn_group

_bounded = bounded(120)

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from serf_tpu_torch import prng
from serf_tpu_torch.models import swim
from serf_tpu_torch.parallel import mesh as tmesh
from serf_tpu_torch.parallel import multihost as mh
from serf_tpu_torch.parallel import placed as tp

torch.set_num_threads(1)
local = int(sys.argv[1])
mh.initialize_multihost(timeout_s=60)
w, rank = dist.get_world_size(), dist.get_rank()
mesh = mh.make_hybrid_mesh(local, device="cpu")
p = w * local
nl = 24
n = nl * p
G = tp.Layout(mesh, n)
I = tp.Layout(tmesh.make_mesh(devices=["cpu"] * p, placed=True), n)
assert isinstance(G, tp.GroupLayout) and type(I) is tp.Layout
lo, hi = G.first, G.first + G.L
rng = np.random.default_rng(7)
cpu = torch.device("cpu")
res = {}


def same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


def check(name, ok):
    res[name] = bool(res.get(name, True) and ok)


def pieces(t):
    return list(torch.chunk(t, p))


planes = {
    "int32": torch.from_numpy(
        rng.integers(-2**31, 2**31, (n, 3)).astype(np.int32)),
    "bool": torch.from_numpy(rng.random(n) < 0.3),
    "float32": torch.from_numpy(
        rng.standard_normal((n, 2)).astype(np.float32)),
}
for kind, t in planes.items():
    every = pieces(t)
    mine = every[lo:hi]
    check("gather_all", same(G.gather_all(mine, cpu),
                             I.gather_all(every, cpu)))
    for start in (0, 5, nl, nl + 7, n - 3, n + 11, 3 * n - 1):
        check("window", same(G.window(mine, start, cpu),
                             I.window(every, start, cpu)))
    check("hop", same(G.hop(mine), I.hop(every)[lo:hi]))
    check("rows_of", same(G.rows_of(t), I.rows_of(t)[lo:hi]))
    if kind != "float32":
        # take reads [N] planes (incarnations, liveness, origins)
        col = [x if x.ndim == 1 else x[:, 0].contiguous() for x in every]
        idx = torch.from_numpy(rng.integers(0, n, 40))
        check("take", same(G.take(col[lo:hi], idx), I.take(col, idx)))

for trial in range(4):
    flags = torch.from_numpy(rng.random(p) < 0.15 * trial)
    parts = [f for f in flags]
    check("any", same(G.any(parts[lo:hi]), I.any(parts)))
    sums = [torch.from_numpy(rng.integers(-9, 9**6, (5,)))
            for _ in range(p)]
    check("sum", same(G.sum(sums[lo:hi]), I.sum(sums)))
    tops = [torch.from_numpy(rng.integers(-2**31, 2**31, (7,)).astype(
        np.int32)) for _ in range(p)]
    check("max", same(G.max(tops[lo:hi]), I.max(tops)))
    covs = [torch.from_numpy(rng.random(9) < 0.9) for _ in range(p)]
    check("all", same(G.all(covs[lo:hi]), I.all(covs)))
    has = [torch.from_numpy(rng.random(6) < 0.3) for _ in range(p)]
    first = [torch.from_numpy(rng.integers(s * nl, (s + 1) * nl, (6,)))
             for s in range(p)]
    check("lowest", same(G.lowest(has[lo:hi], first[lo:hi]),
                         I.lowest(has, first)))
    check("broadcast", same(G.broadcast(tops[0]),
                            I.broadcast(tops[0])[lo:hi]))

cfg = swim.flagship_config(n, k_facts=32)
st = swim.make_cluster(cfg, prng.key(0), device="cpu")
placed = mh.shard_cluster_hybrid(st, mesh)
back = tmesh.gather_state(placed, "cpu")
flat = tmesh._flat_with_names
check("gather_state", all(
    same(a[2], b[2]) for a, b in zip(flat(st), flat(back))
    if isinstance(a[2], torch.Tensor)))
check("replicas_differ", tmesh.replicas_differ(placed) == [])
last = placed.shards[-1]
if rank == w - 1:
    facts = last.gossip.facts
    kind = facts.kind.clone()
    kind[0] += 1
    last = last._replace(gossip=last.gossip._replace(
        facts=facts._replace(kind=kind)))
changed = tmesh.PlacedState(placed.shards[:-1] + (last,), mesh)
check("replicas_differ", tmesh.replicas_differ(changed)
      == [f".gossip.facts.kind (shard {p - 1})"])
print(json.dumps(res))
dist.destroy_process_group()
"""

PRIMITIVES = ("broadcast", "any", "sum", "max", "all", "lowest",
              "gather_all", "window", "take", "rows_of", "hop",
              "gather_state", "replicas_differ")
LAYOUTS = ((2, 2), (4, 1))
_RESULTS = {}


def group_answers(world: int, local: int) -> list:
    """Each rank's ``{primitive: equal}``, cached for the module."""
    if (world, local) not in _RESULTS:
        with hard_limit(100):
            res = spawn_group(world, ["-c", _WORKER, str(local)], limit=80)
        for r, (rc, _, err) in enumerate(res):
            assert rc == 0, f"rank {r} of {world}x{local}: {err[-3000:]}"
        _RESULTS[world, local] = [json.loads(out.strip().splitlines()[-1])
                                  for _, out, _ in res]
    return _RESULTS[world, local]


@pytest.mark.parametrize("world,local", LAYOUTS,
                         ids=[f"{w}x{l}" for w, l in LAYOUTS])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_group_primitive_equals_in_process_body(name, world, local):
    answers = group_answers(world, local)
    assert len(answers) == world
    for rank, got in enumerate(answers):
        assert got.get(name) is True, (rank, name, got)
