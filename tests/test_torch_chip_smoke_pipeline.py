"""``chip_smoke.py`` phase 21 rehearsed on the CPU at small sizes.

Both spawns (two ranks of a width-8 staged ResNet-18 at 16x16, four ranks
of a small staged encoder on ``{"stage": 2, "seq": 2}``) and every check
of (a)-(c). The flash kernels' plain versions count no launches, so the
launch checks, and only they, refuse the run. A file of its own, so that
its spawns run beside ``tests/test_torch_chip_smoke.py``'s long phases
rather than after them.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # lint-ok: unused-imports (autouse fixture)  # noqa: E402


def test_pipeline_phase_rehearses_on_the_cpu(monkeypatch):
    for name, value in dict(
            PIPE_BACKBONE="resnet18", PIPE_WIDTH=8, VISION_SIZE=16,
            PIPE_BATCH=8, PIPE_MICRO=2, PIPE_STEPS=2, PIPE_PARITY_STEPS=2,
            PIPE_TEXT=dict(vocab_size=64, num_classes=2, num_stages=2,
                           num_layers=2, hidden=16, heads=2, max_len=32),
            PIPE_TEXT_MICRO=2, PIPE_GBDT_ROWS=4000, PIPE_GBDT_ITERS=4,
            PIPE_GBDT_KILL=2).items():
        monkeypatch.setattr(cs, name, value)
    with pytest.raises(AssertionError, match="phase 21 failed") as err:
        cs.pipeline_path("cpu")
    lines = str(err.value).splitlines()[1:]
    # every ring and Ulysses fit on every rank: no kernel launched
    assert len(lines) == 2 * 2 * cs.PIPE_TEXT_RANKS, lines
    assert all("flash launches" in ln for ln in lines), lines
