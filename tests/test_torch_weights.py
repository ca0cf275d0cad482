"""Weights carried from the JAX package's npz format into the port."""

from pathlib import Path

import numpy as np
import pytest
import torch

from waveverify_torch.config import TrainConfig, apply_model_config
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules.conv import NormConv1d, NormConvTranspose1d
from waveverify_torch.weights import flatten, load_params, read_npz

torch.set_num_threads(2)

R5 = Path(__file__).resolve().parent.parent / "weights" / "waveverify_demo_r5.npz"


@pytest.fixture(scope="module")
def r5():
    flat, snap = read_npz(R5)
    models = WatermarkModels(apply_model_config(TrainConfig(), snap))
    consumed = (load_params(models.generator, flat, "generator")
                | load_params(models.detector, flat, "detector"))
    return flat, snap, models, consumed


def test_npz_is_upcast_f32_with_config(r5):
    flat, snap, _, _ = r5
    assert all(v.dtype == np.float32 for v in flat.values())
    assert snap["Generator"]["msg_mode"] == "carrier"
    assert snap["Generator"]["film_carrier_gain"] == 0.5
    with np.load(R5) as z:
        k = "generator/encoder/conv_pre/conv/v"
        np.testing.assert_array_equal(flat[k], np.asarray(z[k], np.float32))


def test_every_generator_and_detector_key_is_consumed(r5):
    flat, _, _, consumed = r5
    wanted = {k for k in flat if k.split("/")[0] in ("generator", "detector")}
    assert consumed == wanted


def test_locator_keys_left_for_the_locator_slice(r5):
    flat, _, _, consumed = r5
    left = set(flat) - consumed
    assert left and all(k.startswith("locator/") for k in left)


def test_shapes_follow_the_layout_map(r5):
    flat, _, models, _ = r5
    for key, value in flat.items():
        net, *path = key.split("/")
        if net == "locator":
            continue
        module = getattr(models, net)
        owner = module.get_submodule(".".join(path[:-1]))
        name = path[-1]
        if isinstance(owner, NormConv1d) and name == "v":
            expect = np.transpose(value, (2, 1, 0))
        elif isinstance(owner, torch.nn.Linear) and name == "kernel":
            name, expect = "weight", value.T
        else:  # transposed-conv v, g, biases: unchanged
            expect = value
        got = getattr(owner, name).detach().numpy()
        np.testing.assert_array_equal(got, expect, err_msg=key)
    tr = models.generator.decoder.up_0_dw.convtr
    assert isinstance(tr, NormConvTranspose1d) and tuple(tr.v.shape) == (1536, 1, 16)
    assert tuple(models.generator.decoder.block_0_0.block_0_pw.conv.v.shape) == (768, 768, 1)


def test_flatten_nested_params():
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros((1, 2))}}}
    assert sorted(flatten(tree)) == ["a/b", "a/c/d"]


def test_unknown_or_missing_keys_raise():
    conv = NormConv1d(2, 3, 1, norm="weight_norm", use_bias=False)
    ok = {"m/v": np.zeros((1, 2, 3), np.float32), "m/g": np.ones(3, np.float32)}
    assert load_params(conv, ok, "m") == set(ok)
    with pytest.raises(KeyError):
        load_params(conv, {**ok, "m/b": np.zeros(3, np.float32)}, "m")
    with pytest.raises(KeyError):
        load_params(conv, {"m/v": ok["m/v"]}, "m")
