"""One train step of the ``grouped`` variant (``tests/variants.py``: a
learned skip scale of each kind, grouped convs, layer / spectral / group
norm, GELU, ReLU, Sigmoid, replicate padding, dilation base 2) at the tiny
size against the JAX package, f32 on the CPU (``tests/train_parity.py``):
the losses within rel 1e-4, the pre-clip gradient norms within rel 1e-4 or
three times the port's own f32 noise floor where that is larger, and every
gradient leaf of every network within ``TOL``.

The generator's last conv has one output channel, so its layer norm
makes the residual its bias alone (in both packages, whatever the audio
and the message); ``train_parity`` moves that bias off zero.

``TOL`` is ``GRAD_TOL`` but for the detector, whose every conv divides by
a 9-step power iteration (spectral norm): its worst leaf reads 2.2e-4
against JAX, and the port's own spread at 1e-7 relative audio is 1.5e-3;
the limit is about four times the reading, as ``test_torch_train.py``
sets its own."""

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

TOL = dict(GRAD_TOL, detector=1e-3)


def configure(cfg):
    return variants.apply(cfg, "grouped")


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
