"""Reference-layout checkpoints from flax-named weights, numpy only (it
imports neither JAX nor either package, so ``chip_smoke.py`` uses it on
the card too).

:func:`to_reference_state_dicts` inverts the JAX package's
``convert.py`` converters: flat '/'-joined flax-named arrays (as
``weights.export_params`` or ``read_npz`` give them) go in; the reference
models' state dicts come out, with its module paths
(``encoder.conv_pre.1.conv.conv.weight``, ``decoder.model.{i}...``,
``encoder.msg_embedding.{n}``, ...) and its layouts, weight-norm kernels
fused (``W = g * v / ||v||``) or, with ``parametrized=True``, as the
un-stripped ``parametrizations.weight.original0/1`` pair. Converting the
result gives back ``v`` up to the f32 rounding of the fusion and ``g =
||W||``: the original tree where ``g = ||v||`` (as at init), an equivalent
one (the same effective kernels) elsewhere.

The SEANet options are written as the port's converter reads them (the
JAX package's converter assumes weight norm and no ``act_all``), given
each network's ``norm`` and ``act_all`` (``cfg``): an ``act_all`` block's
convs at ``block.{4k+1}`` / ``block.{4k+3}``; ``skip_scale``,
``res_scale_param``, ``scale_param`` and ``spec.weight`` by name; weight
standardization as the standardized kernel ``W = g * (v - mean) /
sqrt(max(var * fan_in, 1e-7))``; spectral norm as torch's un-removed
``weight_orig`` (= ``v``); layer and group norm as a plain kernel and the
norm module's ``norm.weight`` / ``norm.bias``. Only weight norm has an
un-stripped (``parametrized``) form.

:func:`save_pth` writes them in each form the converters accept.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value, np.float32)
    return tree


def _put_conv(sd: dict, prefix: str, p: dict, o: dict,
              transposed: bool = False) -> None:
    """A conv's leaves under its network's options ``o`` (``norm``,
    ``parametrized``) as the reference's kernel at ``prefix.weight`` (torch
    layout; ``weight_orig`` under spectral norm), its bias, and its norm
    module's keys beside the conv."""
    norm = o["norm"]
    v = p["v"].astype(np.float64)
    if transposed:  # (Cin, Cout / g, K): the torch layout already
        axes, to_torch = (1, 2), (0, 1, 2)
    else:  # WIO (K, Cin / g, Cout) -> (Cout, Cin / g, K)
        axes, to_torch = (0, 1), (2, 1, 0)
    v_t = np.ascontiguousarray(np.transpose(v, to_torch))
    key = f"{prefix}.weight_orig" if norm == "spectral_norm" else f"{prefix}.weight"
    if norm == "weight_norm" and o["parametrized"]:
        g = p["g"].astype(np.float64)
        sd[f"{prefix}.parametrizations.weight.original0"] = (
            g.reshape((-1,) + (1,) * (v.ndim - 1)).astype(np.float32))
        sd[f"{prefix}.parametrizations.weight.original1"] = v_t.astype(np.float32)
        key = None
    elif norm == "weight_norm":
        g = p["g"].astype(np.float64)
        nv = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
        w = g.reshape([-1 if i not in axes else 1 for i in range(v.ndim)]) \
            * v / np.maximum(nv, 1e-12)
    elif norm == "weight_standardization":
        fan_in = int(np.prod([v.shape[a] for a in axes]))
        std = np.sqrt(np.maximum(v.var(axis=axes, keepdims=True) * fan_in, 1e-7))
        w = p["g"].astype(np.float64) * (v - v.mean(axis=axes, keepdims=True)) / std
    else:
        w = v
    if key is not None:
        sd[key] = np.ascontiguousarray(np.transpose(w, to_torch)).astype(np.float32)
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]
    if "norm" in p:
        leaves = p["norm"].get("LayerNorm_0", p["norm"])
        base = prefix.rsplit(".", 1)[0]
        sd[f"{base}.norm.weight"] = leaves["scale"]
        sd[f"{base}.norm.bias"] = leaves["bias"]


def _put_plain(sd: dict, prefix: str, p: dict, transposed: bool) -> None:
    v = p["v"] if transposed else np.transpose(p["v"], (2, 1, 0))
    sd[f"{prefix}.weight"] = np.ascontiguousarray(v)
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def _put_dense(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(p["kernel"].T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = p["bias"]


def _put_resblock(sd: dict, prefix: str, p: dict, o: dict) -> None:
    per_k = 4 if o["act_all"] else 3
    for name, sub in p.items():
        m = re.fullmatch(r"block_(\d+)_(pw|dw)", name)
        if m:
            k = int(m.group(1))
            idx = per_k * k + (1 if m.group(2) == "pw" else per_k - 1)
            _put_conv(sd, f"{prefix}.block.{idx}.conv.conv", sub["conv"], o)
        elif name in ("res_scale_param", "skip_scale"):
            sd[f"{prefix}.{name}"] = sub
        elif name == "shortcut":
            _put_conv(sd, f"{prefix}.shortcut.conv.conv", sub["conv"], o)
        else:
            raise KeyError(f"{prefix}: no reference path for {name}")


def _put_spec_block(sd: dict, prefix: str, p: dict, o: dict) -> None:
    if "stft" in p:
        sd[f"{prefix}.spec.weight"] = np.ascontiguousarray(
            np.transpose(p["stft"]["weight"], (2, 1, 0)))
    if "proj" in p:
        _put_conv(sd, f"{prefix}.layer.conv.conv", p["proj"]["conv"], o)
    if "scale_param" in p:
        sd[f"{prefix}.scale_param"] = p["scale_param"]


def _put_encoder(sd: dict, enc: dict, o: dict, prefix: str = "encoder") -> None:
    msg = sorted((k for k in enc if k.startswith("msg_hidden_")),
                 key=lambda k: int(k.rsplit("_", 1)[1]))
    for name, p in enc.items():
        if name == "conv_pre":
            _put_conv(sd, f"{prefix}.conv_pre.1.conv.conv", p["conv"], o)
        elif m := re.fullmatch(r"block_(\d+)_(\d+)", name):
            _put_resblock(sd, f"{prefix}.blocks.{m.group(1)}.{m.group(2)}", p, o)
        elif m := re.fullmatch(r"spec_block_(\d+)", name):
            _put_spec_block(sd, f"{prefix}.spec_blocks.{m.group(1)}", p, o)
        elif m := re.fullmatch(r"down_(\d+)_(expand|dw)", name):
            j = 2 if m.group(2) == "expand" else 3
            _put_conv(sd, f"{prefix}.downsample.{m.group(1)}.{j}.conv.conv",
                      p["conv"], o)
        elif m := re.fullmatch(r"film_(\d+)_(\d+)", name):
            base = f"{prefix}.film_layers.{m.group(1)}.{m.group(2)}"
            _put_dense(sd, f"{base}.gamma_layer", p["gamma"])
            _put_dense(sd, f"{base}.beta_layer", p["beta"])
        elif name == "spec_post":
            _put_spec_block(sd, f"{prefix}.spec_post", p, o)
        elif name == "post_dw":
            _put_conv(sd, f"{prefix}.conv_post.1.conv.conv", p["conv"], o)
        elif name == "post_proj":
            conv = dict(p["conv"]["conv"])
            if "b" in p:  # the L2Norm path's bias, after the normalisation
                conv["b"] = p["b"]
            _put_conv(sd, f"{prefix}.conv_post.2.conv.conv", conv, o)
        elif name == "msg_in":
            _put_dense(sd, f"{prefix}.msg_embedding.0", p)
        elif name.startswith("msg_hidden_"):
            # Linear layers of the reference's MLP sit at even indices
            _put_dense(sd, f"{prefix}.msg_embedding.{2 * (msg.index(name) + 1)}", p)
        else:
            raise KeyError(f"{prefix}: no reference path for {name}")


def _put_decoder(sd: dict, dec: dict, o: dict, prefix: str = "decoder") -> None:
    n_scales = len([k for k in dec if re.fullmatch(r"up_\d+_dw", k)])
    n_res = len([k for k in dec if re.fullmatch(r"block_0_\d+", k)])
    _put_conv(sd, f"{prefix}.model.0.conv.conv", dec["conv_in"]["conv"], o)
    _put_conv(sd, f"{prefix}.model.1.conv.conv", dec["conv_in_dw"]["conv"], o)
    idx = 2
    for i in range(n_scales):
        _put_conv(sd, f"{prefix}.model.{idx + 2}.convtr.convtr",
                  dec[f"up_{i}_dw"]["convtr"], o, transposed=True)
        _put_conv(sd, f"{prefix}.model.{idx + 3}.conv.conv",
                  dec[f"up_{i}_proj"]["conv"], o)
        for j in range(n_res):
            _put_resblock(sd, f"{prefix}.model.{idx + 4 + j}", dec[f"block_{i}_{j}"], o)
        idx += 4 + n_res
    _put_conv(sd, f"{prefix}.model.{idx + 2}.conv.conv", dec["conv_out"]["conv"], o)


def to_reference_state_dicts(flat: Mapping[str, np.ndarray],
                             parametrized: bool = False, cfg=None
                             ) -> Dict[str, Dict[str, np.ndarray]]:
    """``{net: reference state dict}`` for the generator, detector and
    locator of ``flat`` (keys ``<net>/<flax path>``). ``cfg`` (either
    package's TrainConfig) gives each network's ``norm`` and ``act_all``;
    without it every network has weight norm and no ``act_all``."""
    tree = _nest(flat)

    def opts(net):
        sec = getattr(cfg, net, None)
        return {"norm": getattr(sec, "norm", "weight_norm"),
                "act_all": getattr(sec, "act_all", False),
                "parametrized": parametrized}

    out: Dict[str, Dict[str, np.ndarray]] = {}
    gen: Dict[str, np.ndarray] = {}
    _put_encoder(gen, tree["generator"]["encoder"], opts("generator"))
    _put_decoder(gen, tree["generator"]["decoder"], opts("generator"))
    out["generator"] = gen
    for net in ("detector", "locator"):
        sd: Dict[str, np.ndarray] = {}
        _put_encoder(sd, tree[net]["encoder"], opts(net))
        _put_plain(sd, "reverse_convolution", tree[net]["reverse_convolution"],
                   transposed=True)
        _put_plain(sd, "last_layer", tree[net]["last_layer"], transposed=False)
        out[net] = sd
    return out


def save_pth(path, sds: Mapping[str, Mapping[str, np.ndarray]],
             form: str = "atomic", wrapper: str = "module.") -> None:
    """Write ``sds`` as torch tensors in one of the forms the converters
    take: ``atomic`` (``{step, models: {...}}``), ``composite`` (``{net:
    state dict}``) or ``bare`` (one flat dict of ``<net>.<wrapper><key>``:
    the state dict of a module holding the three networks, each wrapped in
    DataParallel (``module.``) or compiled (``_orig_mod.``))."""
    import torch

    tensors = {net: {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in sd.items()} for net, sd in sds.items()}
    if form == "atomic":
        obj = {"step": 0, "models": tensors}
    elif form == "composite":
        obj = tensors
    elif form == "bare":
        obj = {f"{net}.{wrapper}{k}": v for net, sd in tensors.items()
               for k, v in sd.items()}
    else:
        raise ValueError(f"unknown form {form!r}")
    torch.save(obj, str(path))
