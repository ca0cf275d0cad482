"""The JAX trainer's orbax checkpoints in the port, on the CPU:
``waveverify_torch.train.ocdbt`` against orbax and tensorstore, and the
orbax routes of ``WaveVerify`` and ``save_converted`` against the JAX
package's. Every orbax directory but the committed fixture is written
here, by the JAX package (or tensorstore), at the tiny width.

- The reader: every leaf of a TrainState, in both optimizer layouts (the
  plain ``adamw`` chain and the r5 recipe's ``multi_transform``, every
  optimizer leaf drawn at random so none is zero), equals orbax's own
  structure-free restore bit for bit: ``<i4`` scalars, ``None`` for
  optax's masked leaves, values inline in the b-tree leaf and indirect in
  the per-process store's data files, through the two-level manifest.
  A store with interior nodes and a version tree (tensorstore, small
  nodes, 20 commits) reads as tensorstore reads it; so do zarr arrays of
  every dtype, both orders, several chunks and absent chunks.
- Failures: a flipped byte in a node or a manifest, a missing
  ``libzstd``, an unknown codec, an extra weight all raise.
- Serving: ``WaveVerify`` on the port and on JAX, given the same
  directory, within ``tests/test_torch_convert.py``'s limits, bits equal:
  at the tiny width (a tag and its root serve the same bits), and r5
  written by JAX at batch 2 x 16000.
- The writer: the port's ``save_converted`` is restored bit for bit by
  JAX's ``load_params`` and by its ``WaveVerify`` (the weights the
  ``.pth`` gives it), the port serves the same bits from it as from the
  ``.pth``, and ``tensorstore.ocdbt.dump`` parses it.
- The committed fixture reads the same through orbax and the port.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from tests.reference_checkpoint import save_pth, to_reference_state_dicts
from tests.test_torch_convert import _serve_equal
from tests.torch_jax_bridge import jax_params, tiny_configs
from waveverify_tpu.api.core import WaveVerify as JWaveVerify
from waveverify_tpu.config import DiscriminatorConfig
from waveverify_tpu.config import model_config_dict as jmodel_config_dict
from waveverify_tpu.convert import load_weights_npz
from waveverify_tpu.train import checkpoint as jckpt
from waveverify_tpu.train.state import TrainState as JTrainState
from waveverify_tpu.train.state import make_optimizers
from waveverify_torch import WaveVerify, save_converted
from waveverify_torch.convert import convert_torch_checkpoint
from waveverify_torch.models import WatermarkModels
from waveverify_torch.modules.conv import init_params
from waveverify_torch.train import ocdbt
from waveverify_torch.weights import read_npz

torch.set_num_threads(2)

R5 = "weights/waveverify_demo_r5.npz"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "orbax_tiny_run"
LAYOUTS = {"plain": {}, "multi_transform": dict(detector_lr_mult=10.0,
                                                generator_lr_mult=2.0)}


def _jax_state(mult, seed=0):
    """A JAX TrainState of the tiny config (the MRD alone) holding the
    port's seed-0 parameters, every optimizer leaf drawn at random."""
    jcfg, tcfg = tiny_configs(4)
    jcfg = dataclasses.replace(
        jcfg, optim=dataclasses.replace(jcfg.optim, **mult),
        discriminator=DiscriminatorConfig(periods=(), fft_sizes=(256,)))
    models = WatermarkModels(dataclasses.replace(
        tcfg, discriminator=type(tcfg.discriminator)(periods=(), fft_sizes=(256,))),
        discriminator=True)
    init_params(models, torch.Generator().manual_seed(seed))
    wm, disc = jax_params(models)
    wm_tx, disc_tx = make_optimizers(jcfg.optim)
    rng = np.random.RandomState(seed + 1)

    def draw(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            return jnp.asarray(rng.randint(1, 10 ** 6, x.shape), x.dtype)
        return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 1e-3)

    state = JTrainState(step=jnp.asarray(7, jnp.int32), wm_params=wm, disc_params=disc,
                        wm_opt_state=jax.tree_util.tree_map(draw, wm_tx.init(wm)),
                        disc_opt_state=jax.tree_util.tree_map(draw, disc_tx.init(disc)))
    return state, jcfg


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{layout: (checkpoint root, JAX config)}, written by the JAX package."""
    out = {}
    for name, mult in LAYOUTS.items():
        root = tmp_path_factory.mktemp(name)
        state, jcfg = _jax_state(mult)
        jckpt.save_checkpoint(str(root), "latest", state,
                              {"step": 7, "model_config": jmodel_config_dict(jcfg)})
        out[name] = root, jcfg
    return out


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)


def _assert_same_tree(ours, ref):
    (a, sa), (b, sb) = _leaves(ours), _leaves(ref)
    assert sa == sb
    for (path, x), (_, y) in zip(a, b):
        if y is None:
            assert x is None, path
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reader_equals_orbax_restore(written, layout):
    root, _ = written[layout]
    ours, meta = ocdbt.read_state(root / "latest")
    ref, ref_meta = jckpt.load_state_free(str(root), "latest")
    _assert_same_tree(ours, ref)
    assert meta == ref_meta
    assert ours["step"].dtype == np.int32 and ours["step"].shape == ()
    if layout == "multi_transform":
        inner = ours["wm_opt_state"]["inner_states"]["detector"]["inner_state"]
        assert inner[0]["mu"]["generator"]["encoder"]["conv_pre"]["conv"]["v"] is None
        assert inner[0]["mu"]["detector"]["encoder"]["conv_pre"]["conv"]["v"] is not None
    _assert_same_tree(ocdbt.read_params(root / "latest"), ref["wm_params"])


def test_reader_walks_both_manifests_inline_and_indirect_values(written):
    """The store as orbax writes it: a root manifest whose b-tree leaf
    points into ``ocdbt.process_0/``'s data files, values inline (up to
    1024 bytes) and indirect; every key reads as tensorstore reads it."""
    state = written["multi_transform"][0] / "latest" / "state"
    assert (state / "manifest.ocdbt").exists()
    assert (state / "ocdbt.process_0" / "manifest.ocdbt").exists()
    base = ts.KvStore.open(f"file://{state}/").result()
    root = ts.ocdbt.dump(base).result()["versions"][-1]["root"]["location"]
    entries = ts.ocdbt.dump(base, root).result()["entries"]
    assert any("inline_value" in e for e in entries)
    indirect = [e for e in entries if "inline_value" not in e]
    assert indirect and all(e["indirect_value"].startswith("value:ocdbt.process_0/:d/")
                            for e in indirect)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{state}/"}).result()
    store = ocdbt.OcdbtStore(state)
    keys = sorted(kv.list().result())
    assert store.keys() == keys
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key
    scalars = [k for k in keys if k.endswith(b".count/.zarray")]
    assert scalars and all(json.loads(store.read(k))["dtype"] == "<i4" for k in scalars)


def test_reader_walks_interior_nodes_and_the_version_tree(tmp_path):
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 4096, "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    for g in range(20):
        with ts.Transaction() as txn:
            for i in range(g * 150, (g + 1) * 150):
                kv.with_transaction(txn)[f"key/{i:06d}/x"] = b"v%d" % i * (1 + i % 7)
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    assert dump["versions"][-1]["root_height"] >= 1 and dump["version_tree_nodes"]
    store = ocdbt.OcdbtStore(tmp_path)
    keys = sorted(kv.list().result())
    assert len(keys) == 3000 and store.keys() == keys
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key


ZARR = [("<f8", "C", None), ("<i8", "F", {"id": "zstd", "level": 3}),
        ("|b1", "C", {"id": "zstd", "level": 1}), ("bfloat16", "C", None),
        ("<f4", "F", {"id": "zstd", "level": 1})]


@pytest.mark.parametrize("dtype, order, compressor", ZARR, ids=lambda v: str(v))
def test_zarr_arrays_read_as_tensorstore_writes_them(tmp_path, dtype, order, compressor):
    """Several chunks with partial edges, one chunk never written (it
    takes the fill value), each dtype and order."""
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "a", "create": True,
            "metadata": {"dtype": dtype, "shape": [5, 7], "chunks": [2, 3],
                         "order": order, "compressor": compressor,
                         "fill_value": True if dtype == "|b1" else 3}}
    arr = ts.open(spec).result()
    rng = np.random.RandomState(0)
    data = rng.randn(5, 7) * 10
    arr[:4, :] = data[:4].astype(arr.dtype.numpy_dtype)
    ref = arr.read().result()
    ours = ocdbt.read_array(ocdbt.OcdbtStore(tmp_path), "a")
    assert np.asarray(ref).dtype.itemsize <= ours.dtype.itemsize
    np.testing.assert_array_equal(ours, np.asarray(ref).astype(ours.dtype))
    assert (ours[4] == (True if dtype == "|b1" else 3)).all()


def test_unknown_codec_raises(tmp_path):
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "a", "create": True,
            "metadata": {"dtype": "<f4", "shape": [4], "chunks": [4]}}  # blosc
    ts.open(spec).result()[:] = np.ones(4, np.float32)
    with pytest.raises(ValueError, match="compressor 'blosc'"):
        ocdbt.read_array(ocdbt.OcdbtStore(tmp_path), "a")


def _copy(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("part", ["node", "manifest"])
def test_a_flipped_byte_raises(written, tmp_path, part):
    tag = _copy(written["plain"][0] / "latest", tmp_path / "latest")
    state = tag / "state"
    if part == "manifest":
        path, at = state / "manifest.ocdbt", 20
    else:  # the root's b-tree leaf: the one data file of the root store
        path, at = next((state / "d").iterdir()), 30
    raw = bytearray(path.read_bytes())
    raw[at] ^= 0x10
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        ocdbt.read_state(tag)


def test_a_missing_libzstd_raises_naming_it(monkeypatch, written):
    monkeypatch.setattr(ocdbt, "_zstd", None)
    monkeypatch.setattr(ocdbt.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(ocdbt, "ZSTD_SONAME", "libzstd-missing.so.1")
    with pytest.raises(OSError, match="libzstd-missing.so.1"):
        ocdbt.read_state(written["plain"][0] / "latest")


def test_waveverify_serves_an_orbax_directory_as_jax_does(written):
    """The root and its tag serve the same bits in the port; the root
    serves JAX's ``WaveVerify``'s, the architecture from ``meta.json``."""
    root, jcfg = written["multi_transform"]
    tw, tag = WaveVerify(root, device="cpu"), WaveVerify(root / "latest", device="cpu")
    jw = JWaveVerify(str(root), precision="highest")
    assert tw.config.generator.channels_dec == jw.config.generator.channels_dec == 12
    rng = np.random.RandomState(7)
    audio = (rng.randn(2, 3200) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (2, 16)).astype(np.float32)
    w = tw.embed_batch(audio, bits)
    np.testing.assert_array_equal(tag.embed_batch(audio, bits), w)
    for x, y in zip(tag.detect_batch(w), tw.detect_batch(w)):
        np.testing.assert_array_equal(x, y)
    _serve_equal(tw, jw, 3200, 6)


def test_an_extra_weight_raises(tmp_path):
    state, jcfg = _jax_state({})
    wm = dict(state.wm_params, extra={"w": jnp.ones(3)})
    jckpt.save_checkpoint(str(tmp_path), "latest", {"step": 0, "wm_params": wm},
                          {"model_config": jmodel_config_dict(jcfg)})
    with pytest.raises(KeyError, match="extra/w"):
        WaveVerify(tmp_path, device="cpu")


def test_waveverify_serves_r5_written_by_jax(tmp_path):
    """r5 as the JAX package writes it from the ``.npz``, at batch 2 x
    16000: the port's logits within 1e-5 + 1e-5 relative of JAX's (the
    limit of ``test_waveverify_serves_r5_as_a_pth``), bits equal."""
    _, snap = read_npz(R5)
    params = load_weights_npz(R5)
    jckpt.save_checkpoint(str(tmp_path), "latest",
                          {"step": np.int32(0), "wm_params": params},
                          {"model_config": snap})
    tw = WaveVerify(tmp_path, device="cpu")
    jw = JWaveVerify(str(tmp_path), precision="highest")
    _serve_equal(tw, jw, 16000, 3, rtol=1e-5)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A tiny ``.pth`` and the port's ``save_converted`` of it."""
    tmp = tmp_path_factory.mktemp("converted")
    state, jcfg = _jax_state({})
    _, tcfg = tiny_configs(4)
    flat = {f"{net}/{k}": np.array(v) for net in ("generator", "detector", "locator")
            for k, v in _flat(state.wm_params[net]).items()}
    rng = np.random.RandomState(2)
    for k in flat:  # biases and dense layers off their init values
        if not k.endswith(("/v", "/g")):
            flat[k] = (rng.randn(*flat[k].shape) * 0.1).astype(np.float32)
    pth = tmp / "m.pth"
    save_pth(pth, to_reference_state_dicts(flat))
    return pth, save_converted(pth, tmp / "out", tcfg), tcfg, jcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_save_converted_is_restored_by_jax_bit_for_bit(converted):
    pth, tag, tcfg, _ = converted
    assert tag.name == "latest"
    restored = jckpt.load_params(str(tag.parent), "latest")
    want = convert_torch_checkpoint(pth, tcfg)
    _assert_same_tree(restored, jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), want))
    meta = json.loads((tag / "meta.json").read_text())
    assert meta["source"] == str(pth)
    assert meta["model_config"]["Generator"]["channels_dec"] == 12


def test_save_converted_serves_as_its_pth_in_both_packages(converted):
    """JAX's ``WaveVerify`` restores the weights the ``.pth`` gives it, bit
    for bit; the port's serves the same bits from either."""
    pth, tag, tcfg, jcfg = converted
    _assert_same_tree(JWaveVerify(str(tag.parent), config=jcfg).params,
                      JWaveVerify(str(pth), config=jcfg).params)
    rng = np.random.RandomState(8)
    audio = (rng.randn(2, 3200) * 0.1).astype(np.float32)
    bits = rng.randint(0, 2, (2, 16)).astype(np.float32)
    a = WaveVerify(tag.parent, config=tcfg, device="cpu")
    b = WaveVerify(pth, config=tcfg, device="cpu")
    w = a.embed_batch(audio, bits)
    np.testing.assert_array_equal(w, b.embed_batch(audio, bits))
    for x, y in zip(a.detect_batch(w), b.detect_batch(w)):
        np.testing.assert_array_equal(x, y)


def test_tensorstore_parses_what_the_port_writes(converted):
    state = converted[1] / "state"
    base = ts.KvStore.open(f"file://{state}/").result()
    dump = ts.ocdbt.dump(base).result()
    assert dump["config"]["compression"] == {"id": "zstd"}
    version = dump["versions"][-1]
    entries = ts.ocdbt.dump(base, version["root"]["location"]).result()["entries"]
    keys = ocdbt.OcdbtStore(state).keys()
    assert [e["key"] for e in entries] == keys
    assert version["root"]["statistics"]["num_keys"] == len(keys)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{state}/"}).result()
    assert all(kv.read(k).result().value == ocdbt.OcdbtStore(state).read(k)
               for k in keys[:50])


def test_committed_fixture_reads_as_orbax_reads_it():
    ours, meta = ocdbt.read_state(FIXTURE / "latest")
    ref, ref_meta = jckpt.load_state_free(str(FIXTURE), "latest")
    _assert_same_tree(ours, ref)
    assert meta == ref_meta and meta["step"] == int(ours["step"]) == 1
    assert "inner_states" in ours["wm_opt_state"]  # the r5 recipe's layout
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert size <= 12_000_000, size
