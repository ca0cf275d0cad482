"""The port's resume of a JAX ``multi_transform`` checkpoint (the r5
recipe's per-network learning-rate multipliers) against JAX's, on the CPU
(the checks: ``tests/orbax_resume.py``)."""

import pytest
import torch

from tests.orbax_resume import *  # noqa: F401,F403 (the checks)
from tests.orbax_resume import compile_step, resume_case

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    return resume_case("multi_transform", {True: compile_step(True)},
                       tmp_path_factory.mktemp("multi"))
