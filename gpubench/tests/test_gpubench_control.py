"""On the card: the program passes and the control (the reference in
bfloat16 in the program's place) fails the cell's limits, at 64^3 rows
(the cell's own size) and one episode, on three seeds.  The dozen
seeds the limits were set from come from ``python3 -m
gpubench.readings`` (see PERF.md)."""

import pytest

from gpubench import check, readings, run
from gpubench.tests.tiny import make_root


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(tmp_path, cuda_device):
    root = make_root(tmp_path, ngrid=64)
    limits = run.load_cell(root, "tiny-z9")[4]
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        r = readings.read_seed("tiny-z9", seed, 0.0, device=cuda_device,
                               root=root)
        assert check.judge(r["program"], limits)[0], r
        assert not check.judge(r["control"], limits)[0], r
