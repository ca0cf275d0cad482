"""K = 3 steps per dispatch (``train_steps``) against the JAX package's
``make_multi_train_step`` with the discriminator vector ``[True, False,
True]``, f32 on the CPU at the tiny configuration: each step's losses and
norms, the stacked feedback, the parameters after the dispatch (the checks
of ``test_torch_multi_step.py``, whose K = 2 run shares no compile)."""

import pytest

from tests.test_torch_multi_step import (
    CHECKED,
    check_feedback,
    check_losses,
    check_params,
    run_dispatch,
)


@pytest.fixture(scope="module")
def k3():
    return run_dispatch(3)


@pytest.mark.parametrize("name", CHECKED)
def test_dispatch_losses_match_jax(k3, name):
    check_losses(k3, 3, name)


def test_dispatch_feedback_matches_jax(k3):
    check_feedback(k3, 3)


def test_dispatch_params_within_2lr_per_step(k3):
    check_params(k3, 3)
