"""One train step of the ``kernel_alpha`` variant (``tests/variants.py``:
no weight norm, ELU alpha 0.5; the generator's and locator's chains take
the kernel's route, whose plain version runs here, the detector's ``scale``
skips the plain path) at the tiny size against the JAX package, f32 on the
CPU (``tests/train_parity.py``): the losses within rel 1e-4, the pre-clip
gradient norms within rel 1e-4 or three times the port's own f32 noise
floor where that is larger, and every gradient leaf of every network within
``GRAD_TOL``."""

import pytest

from tests import variants
from tests.train_parity import (
    GRAD_TOL,
    NETS,
    noise_floor,
    rel,
    step_both,
    worst_leaf,
)



def configure(cfg):
    return variants.apply(cfg, "kernel_alpha")


@pytest.fixture(scope="module")
def step():
    return step_both(configure)


@pytest.mark.parametrize("name", ["loss", "adv/disc_loss"])
def test_losses_match_jax(step, name):
    tm, values, _, _ = step
    assert rel(tm[name], values[name]) <= 1e-4, (name, float(tm[name]),
                                                 float(values[name]))


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_grad_norms_match_jax(step, net):
    tm, values, _, _ = step
    name = f"grad_norm/{net}"
    floor = noise_floor(configure, tm)[name]
    assert rel(tm[name], values[name]) <= max(1e-4, 3 * floor), (
        name, float(tm[name]), float(values[name]), floor)


@pytest.mark.parametrize("net", NETS)
def test_grads_match_jax(step, net):
    _, _, ours, ref = step
    worst, dev = worst_leaf(ours[net], ref[net])
    assert dev <= GRAD_TOL[net], (worst, dev)
