"""`train.step.train_step` on the reduced expert-free Jamba (Mamba and
attention layers, dense FFNs) against the reference on the CPU: the
cases and bounds of tests/test_torch_train.py, in a file of their own
(the reference's Mamba scan and the port's plain selective scan make
these the slowest of the step-parity cases)."""

import pytest

from test_torch_train import COMBOS, check_train_step
from _torch_parity import one_thread as _one_thread  # noqa: F401


@pytest.mark.parametrize("accum,remat,opt", COMBOS)
def test_train_step_matches_reference(accum, remat, opt):
    check_train_step("jamba-1.5-large-398b", accum, remat, opt)
