"""chip_smoke's phases 3c and 4e (the other eight tails of the window
kernels) rehearsed at a few rays on the CPU.

On CPU tensors the kernels' wrappers run their plain versions, so the
kernel-vs-plain deviations are zero and no launch is counted; what runs is
every other check of the two phases: each tail's launch (``TAIL_LAUNCH``),
its wrong kernels' separations (``TAIL_K1_ORDER_BLIND``,
``TAIL_BWD_WRONGS``, ``TAIL_TOL``), the f32 gaps against f64
(``TAIL_GAP_FACTOR``), the rays' validity and the gradients' finiteness,
so that a broken check shows before a chip run.
"""

from unittest import mock

import torch

import chip_smoke


def test_tail_phases_rehearse_on_the_cpu():
    cpu = torch.device("cpu")
    chip_smoke.phase_tails_vs_plain(cpu, n=64)
    with mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
        out = chip_smoke.phase_tails_main(
            cpu, n=64, steps=2, steps_long=3, steps_grad=2, steps_tab=1,
            check_launches=False)
    assert set(out) == set(chip_smoke.TAILS)
