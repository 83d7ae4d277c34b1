"""One short cell on the card, as the benchmark's command runs it. Skips
where no CUDA card is visible; run on a card with
``python -m pytest -p no:cacheprovider -m cuda annbench/tests``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")


@pytest.mark.cuda
def test_a_short_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "annbench/run.py", "--workload",
         "sift1m-cnns-bf16.batch8k", "--seed", str(2**31 + 101),
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
        timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
