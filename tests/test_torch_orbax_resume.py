"""The port's resume of the JAX trainer's orbax checkpoints against JAX's,
on the CPU: the plain ``adamw`` layout, and a ``multi_transform``
checkpoint resumed under the plain config, where both packages restore the
parameters and step alone (the cases and checks: ``tests/orbax_resume.py``)."""

import pytest
import torch

from tests.orbax_resume import *  # noqa: F401,F403 (the checks)
from tests.orbax_resume import compile_step, resume_case

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def plain_step():
    return compile_step(False)


@pytest.fixture(scope="module", params=["plain", "params_only"])
def resumed(request, plain_step, tmp_path_factory):
    return resume_case(request.param, {False: plain_step},
                       tmp_path_factory.mktemp(request.param))
