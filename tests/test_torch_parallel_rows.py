"""The in-collective rows of ``serf_tpu_torch/parallel/`` against the
reference on the CPU (split from ``test_torch_parallel.py``, whose
helpers it uses, so that neither file holds a tier-1 worker past about
a minute): ``round_telemetry(mesh=)`` (``with_cols`` included, through
the propagation row) and the propagation and invariant rows of a
sharded run, per round, against the reference's gathered rows (its
unsharded run: this jax refuses its in-collective ``shard_map``), for
both schedules x both stamp flavors x the controller off and on, and
bit for bit against the port's own unsharded rows.  Tolerance: the
telemetry row's float-summed ``coverage`` within rtol 1e-6; every other
field exact."""

import numpy as np
import pytest
import torch

from serf_tpu_torch import convert
from serf_tpu_torch.parallel import mesh as tmesh
from test_torch_cluster import _leaves, _mismatches
from test_torch_parallel import _cfg, _port_rows, _ref_rows
from test_torch_telemetry import _assert_telemetry_rows

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("pack", [True, False])
def test_in_collective_rows_match(pack, schedule, control):
    jcfg = _cfg(pack=pack, schedule=schedule, control=control)
    jfinal, jrows, jprows, jcovs, jirows = _ref_rows(pack, control)
    sharded = _port_rows(jcfg, tmesh.make_mesh(8, device="cpu"))
    final, rows, prows, covs, irows = sharded
    assert _mismatches(_leaves(jfinal), convert.to_numpy(final)) == []
    _assert_telemetry_rows(rows, np.asarray(jrows))
    assert np.array_equal(prows, np.asarray(jprows))
    assert np.array_equal(covs, np.asarray(jcovs))
    assert np.array_equal(irows, np.asarray(jirows))
    # the in-collective identity: bit for bit the port's gathered rows
    _, *plain = _port_rows(jcfg, None)
    for got, want in zip((rows, prows, covs, irows), plain):
        assert got.dtype == want.dtype and np.array_equal(got, want)
