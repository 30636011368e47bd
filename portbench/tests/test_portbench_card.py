"""A short run of the command on the card (skips without one)."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_the_command_runs_a_cell_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cornell.render",
         "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["platform"] == "gpu"
    if trace:
        assert last["device"]["busy_s"] > 0
        assert "b1_roofline.render" in last["metrics"]
    else:
        assert last["metrics"]["render_rays_per_s"]["value"] > 0
