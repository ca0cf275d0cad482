"""One train step of the ``wide_skips`` variant (``tests/variants.py``: 1x1
skips, zero-init gates, ``act_all``, LeakyReLU, weight standardization,
centred reflect padding, a power spectrogram and a learned STFT basis) at
the tiny size against the JAX package, f32 on the CPU
(``tests/train_parity.py``): the losses within rel 1e-4, the pre-clip
gradient norms within rel 1e-4 or three times the port's own f32 noise
floor where that is larger, and every gradient leaf of every network within
``TOL``.

``TOL`` is ``GRAD_TOL`` but for the locator: its worst leaf (a spec
block's projection, under weight standardization and the power
spectrogram) reads 3.2e-5 against JAX, and the port's own spread at 1e-7
relative audio is 2.6e-5, above ``GRAD_TOL``'s 2e-5 for the shipped
configuration; the limit is about four times the reading, as
``test_torch_train.py`` sets its own."""

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

TOL = dict(GRAD_TOL, locator=1.2e-4)


def configure(cfg):
    return variants.apply(cfg, "wide_skips")


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
    assert dev <= TOL[net], (worst, dev)
