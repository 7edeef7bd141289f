"""The port's fuzz harnesses (``serf_tpu_torch/fuzz/``) against the
reference's (``fuzz/``, driven by ``tests/test_fuzz_harness.py``).

The reference's three tests run here over the port's codec with fixed
case budgets (a budget, not a wall-clock floor, so a loaded machine
cannot fail them): seed 0 in tier-1 and seed 7 under ``slow`` as
there, every envelope tag 1-10 covered, the dstream slice at 2000
cases.  The differential case: for seeds 0-3 the port's
``arbitrary_message`` makes the reference's draws, and the two encode
them to the same bytes."""

import json
import os
import random
import sys

import pytest

from serf_tpu_torch.fuzz import fuzz_dstream, fuzz_messages
from serf_tpu_torch.fuzz.fuzz_messages import arbitrary_message, encode_any

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fuzz"))

import fuzz_messages as ref_fuzz  # noqa: E402

#: the case budget of the tier-1 slice (the reference's 4 s slice asks
#: more than 500)
CASES = 3000


@pytest.mark.parametrize(
    "seed", [0, pytest.param(7, marks=pytest.mark.slow)])
def test_fuzz_slice_no_contract_violations(seed):
    stats = fuzz_messages.run(seed=seed, seconds=None, cases=CASES)
    assert stats["cases"] == CASES
    assert stats["violations"] == 0, stats["examples"]
    assert stats["native_diffs"] == 0, stats["examples"]
    # the native scanner, LZ4 and snappy took part (g++ builds them)
    assert stats["native"]
    # mutation/garbage probes actually exercised the fail-closed path
    assert stats["decode_errors"] > stats["cases"]


def test_arbitrary_messages_cover_every_envelope_type():
    from serf_tpu_torch.types.messages import decode_message

    rng = random.Random(3)
    seen = set()
    for _ in range(2000):
        m = arbitrary_message(rng)
        raw = encode_any(m)
        seen.add(raw[0])
        assert decode_message(raw) is not None
    assert seen == set(range(1, 11)), f"envelope tags not all covered: {seen}"


def test_dstream_segment_fuzz_slice():
    """The dstream segment fuzzer (untrusted-UDP parser) at 2000 cases."""
    stats = fuzz_dstream.run(seed=1, seconds=60.0, cases=2000)
    assert stats["cases"] >= 2000, f"fuzzer stopped early: {stats['cases']}"
    assert stats["violations"] == 0, stats["examples"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_draws_and_encodings_equal_the_reference(seed):
    """The port's generator makes the reference's draws from one seed:
    the two random streams stay in step, and each message encodes to
    the same bytes in both packages."""
    mine, theirs = random.Random(seed), random.Random(seed)
    for i in range(300):
        got = encode_any(arbitrary_message(mine))
        want = ref_fuzz.encode_any(ref_fuzz.arbitrary_message(theirs))
        assert got == want, (seed, i)
    assert mine.random() == theirs.random()


@pytest.mark.parametrize("which", ["messages", "dstream"])
def test_module_main_prints_one_json_line(which, capsys):
    """Each harness run as its module prints one JSON summary line and
    exits 0 on a clean run."""
    mod = fuzz_messages if which == "messages" else fuzz_dstream
    assert mod.main(["--cases", "200", "--seed", "0"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    stats = json.loads(out[0])
    assert stats["cases"] == 200 and stats["ok"] and stats["violations"] == 0
