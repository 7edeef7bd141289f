"""The controlled ``control-overload-shed`` leg on a placed mesh against
the reference's unsharded run: the cases of ``test_torch_placed_chaos.py``
(its helpers, the same checks) for that plan, split from it so that
neither file holds a tier-1 worker past about a minute."""

import pytest
import torch

from test_torch_placed_chaos import (check_digest_stream,
                                     check_replay_across_placements,
                                     check_rows,
                                     check_state_report_and_ledger, cases)

# one ATen thread per test process: tier-1 runs six xdist workers on
# the machine's cores
torch.set_num_threads(1)

HERE = ("control-overload-shed",)


@pytest.mark.parametrize("name,p", cases(HERE))
def test_placed_plan_state_report_and_ledger(name, p):
    check_state_report_and_ledger(name, p)


@pytest.mark.parametrize("name,p", cases(HERE))
def test_placed_plan_rows(name, p):
    check_rows(name, p)


@pytest.mark.parametrize("name,p", cases(HERE))
def test_placed_plan_digest_stream(name, p):
    check_digest_stream(name, p)


@pytest.mark.parametrize("name", HERE)
def test_placed_recordings_replay_across_placements(name, tmp_path):
    check_replay_across_placements(name, tmp_path)
