"""The reference's event-pipeline, overload and lifecycle scenarios
(``tests/test_pipeline.py``, ``tests/test_overload.py`` and the host part
of ``tests/test_lifecycle.py``), run on both packages with their outcome
summaries held equal (the harness is ``test_torch_host_scenarios.py``'s).
"""

import pytest
import torch

from test_torch_host_scenarios import PACKAGES, check_scenario, scenarios

torch.set_num_threads(1)

#: scenarios that reach a module the port does not have yet
LIFECYCLE_EXCLUDE = {
    # obs/slo.judge_host_run, ROADMAP.md queue 1 item 6(d)
    "test_stage_slo_rows_judge_from_ledger_snapshot",
    # faults/host.py, item 6(d)
    "test_slow_consumer_plan_fires_slow_messages",
    # obs/slo.score_bench (the bench's host-plane bands), item 6(d)
    "test_host_plane_bands_committed_and_gate_flags_regression",
    "test_bench_strict_exits_4_on_host_band_violation",
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize(
    "name,test,kw",
    scenarios("test_pipeline") + scenarios("test_overload")
    + scenarios("test_lifecycle", LIFECYCLE_EXCLUDE))
def test_pipeline_scenario(name, test, kw, pkg, request, monkeypatch,
                           tmp_path_factory):
    check_scenario(name, test, kw, pkg, request, monkeypatch,
                   tmp_path_factory)
