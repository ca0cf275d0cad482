"""One train step of the tiny shipped configuration with
``spec_learnable_effective: true``: the generator's spec blocks own a
trained STFT basis (``stft/weight``), as JAX's ``Generator`` passes the
flag to its encoder as ``spec_learnable``; at the tiny size against the JAX
package, f32 on the CPU (``tests/train_parity.py``): the losses within rel
1e-4, the pre-clip gradient norms within rel 1e-4 or three times the port's
own f32 noise floor where that is larger, and every gradient leaf of every
network within ``GRAD_TOL``."""

import dataclasses

import pytest

from tests.train_parity import (
    GRAD_TOL,
    NETS,
    noise_floor,
    rel,
    step_both,
    worst_leaf,
)



def configure(cfg):
    return dataclasses.replace(cfg, generator=dataclasses.replace(
        cfg.generator, spec_learnable_effective=True))


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


def test_stft_basis_is_a_trained_leaf(step):
    """Every spec block of the generator's encoder has its ``stft/weight``
    leaf and gradient, in both packages; the detector's and locator's do
    not (JAX passes the flag to the generator only)."""
    _, _, ours, ref = step
    leaves = sorted(k for k in ref["generator"] if k.endswith("stft/weight"))
    assert leaves == [f"encoder/{b}/stft/weight" for b in
                      ("spec_block_0", "spec_block_1", "spec_block_2",
                       "spec_block_3", "spec_post")]
    assert all(k in ours["generator"] for k in leaves)
    assert not any("stft" in k for net in ("detector", "locator")
                   for k in ref[net])
