"""Reference PyTorch checkpoints -> the port's parameters (counterpart of
``waveverify_tpu/convert.py``; numpy and ``torch.load``).

Converts the reference's atomic ``.pth`` checkpoints (``{step, models:
{generator, detector, locator, discriminator}, ...}``), composite and bare
state dicts, and per-component state dicts (``module.`` / ``_orig_mod.``
prefixes stripped) into the JAX package's flax-named tree, which
``weights.load_params`` copies into the port's modules: the same tree the
JAX package's ``convert_torch_checkpoint`` gives.

Weight norm: the reference strips parametrizations before saving, so state
dicts hold fused kernels ``W``; ``v = W, g = ||W||`` (in float64, cast to
f32) reproduces it (``g * v / ||v|| == W``). Un-stripped checkpoints
(``parametrizations.weight.original0/1``) are fused first with the same
math. Layouts: torch Conv1d ``(Cout, Cin/g, K)`` -> WIO ``(K, Cin/g,
Cout)``; ConvTranspose1d kept; Conv2d -> HWIO; Linear ``(out, in)`` ->
``(in, out)``.

The SEANet options take their network's ``norm`` and ``act_all`` from the
config (the JAX package's converter assumes weight norm and no
``act_all``): an ``act_all`` block's convs sit at ``block.{4k+1}`` /
``block.{4k+3}``; ``shortcut``, ``skip_scale``, ``res_scale_param``,
``spec.weight`` and ``scale_param`` keep their names; see
:func:`_norm_conv` for each norm's leaves.

:func:`save_converted` writes the converted weights as an orbax inference
checkpoint (``<out_dir>/latest``, through ``train.ocdbt``), which both
packages' ``WaveVerify`` and the JAX package's ``load_params`` read.

AudioSeal's two checkpoints (:func:`load_audioseal`) and WavMark's one
(:func:`load_wavmark`) load straight into their holders' modules.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from waveverify_torch.config import TrainConfig, model_config_dict
from waveverify_torch.train.ocdbt import write_state

logger = logging.getLogger(__name__)

Array = np.ndarray
StateDict = Dict[str, Array]


def load_torch_state_dicts(path: Union[str, Path]) -> Dict[str, StateDict]:
    """Load a reference checkpoint into numpy per-model state dicts.

    Accepts the atomic format (dict with a 'models' key), a bare composite
    state dict, or a single-model state dict.
    """
    import torch

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "models" in ckpt:
        models = ckpt["models"]
    elif isinstance(ckpt, dict) and all(
        isinstance(v, dict) for v in ckpt.values()
    ) and {"generator", "detector", "locator"} & set(ckpt.keys()):
        models = ckpt
    else:
        # bare composite state dict: split on the leading component name
        models = {}
        for key, value in ckpt.items():
            comp, _, rest = key.partition(".")
            models.setdefault(comp, {})[rest] = value

    out: Dict[str, StateDict] = {}
    for name, sd in models.items():
        if not isinstance(sd, dict):
            continue
        if hasattr(sd, "items"):
            out[name] = {
                _strip_prefix(k): np.asarray(v.detach().cpu().numpy(), np.float32)
                if hasattr(v, "detach") else np.asarray(v, np.float32)
                for k, v in sd.items()
            }
    return {k: fuse_parametrizations(v) for k, v in out.items()}


def _strip_prefix(key: str) -> str:
    for prefix in ("module.", "_orig_mod."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def fuse_parametrizations(sd: StateDict) -> StateDict:
    """Fuse un-stripped torch parametrization keys into plain weights
    (weight_norm: W = g * v / ||v||, norm over all dims but 0 — the math in
    reference scripts/train.py:1560-1577)."""
    out: StateDict = {}
    done = set()
    for key in sd:
        m = re.match(r"(.*)\.parametrizations\.weight\.original0$", key)
        if not m:
            continue
        base = m.group(1)
        g = sd[key]
        v = sd[f"{base}.parametrizations.weight.original1"]
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
        out[f"{base}.weight"] = (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
        done.add(key)
        done.add(f"{base}.parametrizations.weight.original1")
    for key, value in sd.items():
        if key not in done and ".parametrizations." not in key:
            out.setdefault(key, value)
    return out


# ---------------------------------------------------------------------------
# Leaf converters
# ---------------------------------------------------------------------------


def _norm_conv(sd: StateDict, prefix: str, transposed: bool = False,
               norm: str = "weight_norm") -> Dict[str, Array]:
    """A torch conv at ``prefix`` (its inner ``Conv`` module) -> the leaves
    of a NormConv{1d,Transpose1d,2d} under ``norm``:

    - weight_norm: ``v = W``, ``g = ||W||``;
    - weight_standardization: ``v = W``, ``g = sqrt(var(W) * fan_in)`` in
      the JAX shape (a standardized W is its own standardization up to the
      gain, whose sign the standardization of W carries);
    - spectral_norm: ``v`` from torch's un-removed ``weight_orig`` when the
      state dict has it, else ``W`` (whose spectral norm is one);
    - none, layer_norm, time_group_norm: ``v = W``, and the norm module's
      ``weight`` / ``bias`` (beside the conv, ``<module>.norm``) as the flax
      norm's ``scale`` / ``bias``."""
    key = f"{prefix}.weight"
    if norm == "spectral_norm" and f"{prefix}.weight_orig" in sd:
        key = f"{prefix}.weight_orig"
    w = sd[key]
    if transposed:
        v = w  # (Cin, Cout/g, K) — our transposed layout matches torch
        axes = tuple(range(1, v.ndim))
    elif w.ndim == 4:
        v = np.transpose(w, (2, 3, 1, 0))  # -> HWIO
        axes = (0, 1, 2)
    else:
        v = np.transpose(w, (2, 1, 0))  # -> WIO
        axes = (0, 1)
    params = {"v": np.ascontiguousarray(v)}
    v64 = v.astype(np.float64)
    if norm == "weight_norm":
        params["g"] = np.sqrt((v64 ** 2).sum(axis=axes)).astype(np.float32)
    elif norm == "weight_standardization":
        fan_in = int(np.prod([v.shape[a] for a in axes]))
        params["g"] = np.sqrt(v64.var(axis=axes, keepdims=True) * fan_in
                              ).astype(np.float32)
    if f"{prefix}.bias" in sd:
        params["b"] = sd[f"{prefix}.bias"]
    norm_prefix = prefix.rsplit(".", 1)[0] + ".norm"
    if norm in ("layer_norm", "time_group_norm"):
        leaves = {"scale": sd[f"{norm_prefix}.weight"],
                  "bias": sd[f"{norm_prefix}.bias"]}
        params["norm"] = ({"LayerNorm_0": leaves} if norm == "layer_norm"
                          else leaves)
    return params


def _has_conv(sd: StateDict, prefix: str) -> bool:
    """Whether a conv sits at ``prefix`` (a spectral-norm conv keeps its
    kernel as ``weight_orig``)."""
    return f"{prefix}.weight" in sd or f"{prefix}.weight_orig" in sd


def _plain_conv(sd: StateDict, prefix: str, transposed: bool = False
                ) -> Dict[str, Array]:
    w = sd[f"{prefix}.weight"]
    v = w if transposed else np.transpose(w, (2, 1, 0))
    params = {"v": np.ascontiguousarray(v)}
    if f"{prefix}.bias" in sd:
        params["b"] = sd[f"{prefix}.bias"]
    return params


def _dense(sd: StateDict, prefix: str) -> Dict[str, Array]:
    params = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        params["bias"] = sd[f"{prefix}.bias"]
    return params


# ---------------------------------------------------------------------------
# Module converters: reference key strings in, nested flax-named dicts out
# ---------------------------------------------------------------------------


def _convert_resblock(sd: StateDict, prefix: str, act_all: bool = False,
                      norm: str = "weight_norm") -> Dict[str, Any]:
    per_k = 4 if act_all else 3
    params: Dict[str, Any] = {}
    k = 0
    while _has_conv(sd, f"{prefix}.block.{k * per_k + 1}.conv.conv"):
        base = k * per_k
        params[f"block_{k}_pw"] = {
            "conv": _norm_conv(sd, f"{prefix}.block.{base + 1}.conv.conv",
                               norm=norm)
        }
        dw_off = 3 if act_all else 2
        params[f"block_{k}_dw"] = {
            "conv": _norm_conv(sd, f"{prefix}.block.{base + dw_off}.conv.conv",
                               norm=norm)
        }
        k += 1
    if f"{prefix}.res_scale_param" in sd:
        params["res_scale_param"] = sd[f"{prefix}.res_scale_param"]
    if _has_conv(sd, f"{prefix}.shortcut.conv.conv"):
        params["shortcut"] = {
            "conv": _norm_conv(sd, f"{prefix}.shortcut.conv.conv", norm=norm)
        }
    if f"{prefix}.skip_scale" in sd:  # the scale / exp_scale skips' gain
        params["skip_scale"] = sd[f"{prefix}.skip_scale"]
    return params


def _convert_spec_block(sd: StateDict, prefix: str,
                        norm: str = "weight_norm") -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    if f"{prefix}.spec.weight" in sd:  # learnable CausalSTFT basis
        params["stft"] = {
            "weight": np.transpose(sd[f"{prefix}.spec.weight"], (2, 1, 0))
        }
    if _has_conv(sd, f"{prefix}.layer.conv.conv"):
        params["proj"] = {"conv": _norm_conv(sd, f"{prefix}.layer.conv.conv",
                                             norm=norm)}
    if f"{prefix}.scale_param" in sd:
        params["scale_param"] = sd[f"{prefix}.scale_param"]
    return params


def _convert_encoder(sd: StateDict, prefix: str = "encoder",
                     norm: str = "weight_norm", act_all: bool = False
                     ) -> Dict[str, Any]:
    enc: Dict[str, Any] = {}
    enc["conv_pre"] = {"conv": _norm_conv(sd, f"{prefix}.conv_pre.1.conv.conv",
                                          norm=norm)}

    i = 0
    while _has_conv(sd, f"{prefix}.downsample.{i}.2.conv.conv"):
        j = 0
        while _has_conv(sd, f"{prefix}.blocks.{i}.{j}.block.1.conv.conv"):
            enc[f"block_{i}_{j}"] = _convert_resblock(
                sd, f"{prefix}.blocks.{i}.{j}", act_all, norm
            )
            j += 1
        spec = _convert_spec_block(sd, f"{prefix}.spec_blocks.{i}", norm)
        if spec:
            enc[f"spec_block_{i}"] = spec
        enc[f"down_{i}_expand"] = {
            "conv": _norm_conv(sd, f"{prefix}.downsample.{i}.2.conv.conv",
                               norm=norm)
        }
        enc[f"down_{i}_dw"] = {
            "conv": _norm_conv(sd, f"{prefix}.downsample.{i}.3.conv.conv",
                               norm=norm)
        }
        b = 0
        while f"{prefix}.film_layers.{i}.{b}.gamma_layer.weight" in sd:
            enc[f"film_{i}_{b}"] = {
                "gamma": _dense(sd, f"{prefix}.film_layers.{i}.{b}.gamma_layer"),
                "beta": _dense(sd, f"{prefix}.film_layers.{i}.{b}.beta_layer"),
            }
            b += 1
        i += 1

    spec_post = _convert_spec_block(sd, f"{prefix}.spec_post", norm)
    if spec_post:
        enc["spec_post"] = spec_post
    enc["post_dw"] = {"conv": _norm_conv(sd, f"{prefix}.conv_post.1.conv.conv",
                                         norm=norm)}
    post = _norm_conv(sd, f"{prefix}.conv_post.2.conv.conv", norm=norm)
    post_b = post.pop("b", None)
    enc["post_proj"] = {"conv": {"conv": post}}
    if post_b is not None:
        # L2Norm path: bias applied after normalization
        # (reference modules/seanet.py:797-828)
        enc["post_proj"]["b"] = post_b

    # message MLP: first Linear -> msg_in, later Linears -> msg_hidden_{k}
    msg_idx = sorted(
        int(m.group(1))
        for key in sd
        if (m := re.match(rf"{re.escape(prefix)}\.msg_embedding\.(\d+)\.weight", key))
    )
    if msg_idx:
        enc["msg_in"] = _dense(sd, f"{prefix}.msg_embedding.{msg_idx[0]}")
        for k, n in enumerate(msg_idx[1:]):
            enc[f"msg_hidden_{k}"] = _dense(sd, f"{prefix}.msg_embedding.{n}")
    return enc


def _convert_decoder(sd: StateDict, cfg: TrainConfig,
                     prefix: str = "decoder") -> Dict[str, Any]:
    g = cfg.generator
    n_scales = len(g.strides)
    n_res = g.n_residual_dec
    norm = g.norm
    dec: Dict[str, Any] = {}
    dec["conv_in"] = {"conv": _norm_conv(sd, f"{prefix}.model.0.conv.conv",
                                         norm=norm)}
    dec["conv_in_dw"] = {"conv": _norm_conv(sd, f"{prefix}.model.1.conv.conv",
                                            norm=norm)}
    idx = 2
    for i in range(n_scales):
        dec[f"up_{i}_dw"] = {
            "convtr": _norm_conv(
                sd, f"{prefix}.model.{idx + 2}.convtr.convtr", transposed=True,
                norm=norm)
        }
        dec[f"up_{i}_proj"] = {
            "conv": _norm_conv(sd, f"{prefix}.model.{idx + 3}.conv.conv",
                               norm=norm)
        }
        for j in range(n_res):
            dec[f"block_{i}_{j}"] = _convert_resblock(
                sd, f"{prefix}.model.{idx + 4 + j}", g.act_all, norm
            )
        idx += 4 + n_res
    dec["conv_out"] = {"conv": _norm_conv(sd, f"{prefix}.model.{idx + 2}.conv.conv",
                                          norm=norm)}
    return dec


def convert_generator(sd: StateDict, cfg: TrainConfig) -> Dict[str, Any]:
    return {
        "encoder": _convert_encoder(sd, "encoder", cfg.generator.norm,
                                    cfg.generator.act_all),
        "decoder": _convert_decoder(sd, cfg, "decoder"),
    }


def convert_detector_like(sd: StateDict, net_cfg=None) -> Dict[str, Any]:
    """Detector and Locator share the structure: encoder + plain
    ConvTranspose1d head + 1x1 conv (reference model/detector.py:178-218,
    model/locator.py:174-183). ``net_cfg`` (the network's config section)
    gives the encoder's norm and ``act_all``."""
    norm = net_cfg.norm if net_cfg is not None else "weight_norm"
    act_all = net_cfg.act_all if net_cfg is not None else False
    return {
        "encoder": _convert_encoder(sd, "encoder", norm, act_all),
        "reverse_convolution": _plain_conv(
            sd, "reverse_convolution", transposed=True
        ),
        "last_layer": _plain_conv(sd, "last_layer"),
    }


def convert_torch_checkpoint(path: Union[str, Path],
                             cfg: Optional[TrainConfig] = None,
                             validate: bool = True,
                             models=None) -> Dict[str, Any]:
    """Full conversion: a reference ``.pth`` -> the nested flax-named tree
    ``{"generator", "detector", "locator"}`` of numpy arrays.

    With ``validate=True`` the tree is shaped onto the port's modules built
    from ``cfg`` (or ``models``, a ``WatermarkModels`` already built):
    entries they lack (the CausalSTFT buffers a state dict may carry) are
    dropped with a warning; a missing entry or a shape mismatch raises."""
    if cfg is None:
        cfg = TrainConfig()
    sds = load_torch_state_dicts(path)
    missing = {"generator", "detector", "locator"} - set(sds)
    if missing:
        raise ValueError(f"checkpoint {path} lacks model(s): {sorted(missing)}")
    wm_params = {
        "generator": convert_generator(sds["generator"], cfg),
        "detector": convert_detector_like(sds["detector"], cfg.detector),
        "locator": convert_detector_like(sds["locator"], cfg.locator),
    }
    if validate:
        wm_params = _conform_tree(target_structure(cfg, models), wm_params)
    return wm_params


def target_structure(cfg: TrainConfig, models=None) -> Dict[str, Any]:
    """The nested flax paths of the port's three networks, each leaf the
    parameter's shape in the flax layout."""
    from waveverify_torch.models import WatermarkModels
    from waveverify_torch.weights import _to_flax_layout

    if models is None:
        models = WatermarkModels(cfg)
    tree: Dict[str, Any] = {}
    for net in ("generator", "detector", "locator"):
        module = getattr(models, net)
        node_net = tree.setdefault(net, {})
        for full, p in module.named_parameters():
            *path, name = full.split(".")
            owner = module.get_submodule(".".join(path))
            name, shaped = _to_flax_layout(owner, name,
                                           np.empty(tuple(p.shape), np.float32))
            node = node_net
            for part in path:
                node = node.setdefault(part, {})
            node[name] = tuple(shaped.shape)
    return tree


def _conform_tree(ref: Any, got: Any, path: str = "") -> Any:
    """Shape the converted tree onto the target structure: extra entries
    are dropped with a warning; missing entries or shape mismatches
    raise."""
    if isinstance(ref, dict):
        got_keys = set(got) if isinstance(got, dict) else set()
        missing = set(ref) - got_keys
        if missing:
            raise ValueError(
                f"param tree mismatch at {path or '<root>'}: "
                f"missing {sorted(missing)}")
        for k in sorted(got_keys - set(ref)):
            logger.warning("dropping unexpected converted entry %s/%s", path, k)
        return {k: _conform_tree(ref[k], got[k], f"{path}/{k}") for k in ref}
    got_shape = tuple(np.shape(got))
    if tuple(ref) != got_shape:
        raise ValueError(
            f"shape mismatch at {path}: expected {tuple(ref)}, got {got_shape}")
    return got


def save_converted(path: Union[str, Path], out_dir: Union[str, Path],
                   cfg: Optional[TrainConfig] = None) -> Path:
    """Convert a ``.pth`` checkpoint and save it as an orbax inference
    checkpoint, ``<out_dir>/latest`` (returned), which
    ``WaveVerify(out_dir)`` of either package serves (the counterpart of
    the JAX package's ``save_converted``).

    The tag holds ``step`` (0) and ``wm_params``, the fields the JAX
    package's ``load_params`` restores, and a ``meta.json`` with the
    source and the architecture (``model_config``). It leaves out the fresh
    optimizer state and the random discriminator that the JAX package's
    version adds, which carry nothing of the ``.pth``."""
    if cfg is None:
        cfg = TrainConfig()
    wm_params = convert_torch_checkpoint(path, cfg)
    return write_state(Path(out_dir) / "latest",
                       {"step": np.asarray(0, np.int32), "wm_params": wm_params},
                       {"source": str(path), "model_config": model_config_dict(cfg)})


# ---------------------------------------------------------------------------
# AudioSeal
# ---------------------------------------------------------------------------

# AudioSeal's keys -> the port's (``AudioSealModels``), applied in order: the
# generator's tree is ``AudioSealWM``'s (encoder, decoder, msg_processor),
# the detector's ``AudioSealDetector``'s (``detector.0`` the encoder and its
# transposed conv, ``detector.1`` the 1x1 conv); a conv's leaves lose the
# inner module of audiocraft's ``NormConv1d`` / ``NormConvTranspose1d``.
# A conv's ``weight`` / ``bias`` then become the port's ``v`` (and ``g =
# ||W||`` under weight norm) / ``b``; every other leaf keeps its name.
AUDIOSEAL_NAMES = (
    (r"^(encoder|decoder|msg_processor)\.", r"generator.\1."),
    (r"^detector\.0\.model\.", "detector.encoder.model."),
    (r"^detector\.0\.reverse_convolution\.", "detector.reverse_convolution."),
    (r"^detector\.1\.", "detector.last_layer."),
    (r"\.conv\.conv\.", ".conv."),
    (r"\.convtr\.convtr\.", ".convtr."),
)


def fuse_weight_g_v(sd: StateDict) -> StateDict:
    """Fuse ``torch.nn.utils.weight_norm``'s ``weight_g`` / ``weight_v``
    into ``weight = g * v / ||v||`` (norm over all dims but 0, in
    float64)."""
    out: StateDict = {}
    for key, value in sd.items():
        if key.endswith(".weight_v"):
            base = key[:-len(".weight_v")]
            axes = tuple(range(1, value.ndim))
            norm = np.sqrt((value.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
            out[f"{base}.weight"] = (sd[f"{base}.weight_g"] * value
                                     / np.maximum(norm, 1e-12)).astype(np.float32)
        elif not key.endswith(".weight_g"):
            out.setdefault(key, value)
    return out


def read_state_dict(path: Union[str, Path]) -> StateDict:
    """A state dict saved with ``torch.save`` (one of AudioSeal's
    checkpoints, ``generator_base.pth`` / ``detector_base.pth``, or
    WavMark's; a ``model`` entry is its state dict) -> numpy float32,
    ``module.`` / ``_orig_mod.`` prefixes stripped, weight norm and
    parametrizations fused."""
    import torch

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    sd = {_strip_prefix(k): np.asarray(v.detach().cpu().float().numpy(), np.float32)
          for k, v in ckpt.items()}
    return fuse_parametrizations(fuse_weight_g_v(sd))


def convert_audioseal(generator_sd: StateDict, detector_sd: StateDict,
                      models) -> Dict[str, Array]:
    """AudioSeal's generator and detector state dicts (fused, as
    :func:`read_state_dict` gives them) -> the state dict of
    ``models`` (an ``AudioSealModels``), through :data:`AUDIOSEAL_NAMES`.
    A key that maps onto no parameter, a parameter no key fills, or a shape
    that differs raises."""
    target = {k: tuple(v.shape) for k, v in models.state_dict().items()}
    out: Dict[str, Array] = {}
    for sd in (generator_sd, detector_sd):
        for key, value in sd.items():
            name = key
            for pattern, repl in AUDIOSEAL_NAMES:
                name = re.sub(pattern, repl, name)
            stem, _, leaf = name.rpartition(".")
            if leaf == "weight" and f"{stem}.v" in target:
                out[f"{stem}.v"] = value
                if f"{stem}.g" in target:
                    axes = tuple(range(1, value.ndim))
                    out[f"{stem}.g"] = np.sqrt(
                        (value.astype(np.float64) ** 2).sum(axis=axes)).astype(np.float32)
            elif leaf == "bias" and f"{stem}.b" in target:
                out[f"{stem}.b"] = value
            else:
                out[name] = value
    extra = sorted(set(out) - set(target))
    if extra:
        raise KeyError(f"AudioSeal entries no parameter takes: {extra[:5]}")
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"parameters not in the AudioSeal checkpoints: {missing[:5]}")
    for name, shape in target.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != {shape}")
    return out


def load_audioseal(models, generator_path: Union[str, Path],
                   detector_path: Union[str, Path]) -> None:
    """Copy AudioSeal's two checkpoints into ``models`` (an
    ``AudioSealModels``)."""
    import torch

    flat = convert_audioseal(read_state_dict(generator_path),
                             read_state_dict(detector_path), models)
    models.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in flat.items()})


# ---------------------------------------------------------------------------
# WavMark
# ---------------------------------------------------------------------------


def convert_wavmark(sd: StateDict, models) -> Dict[str, Array]:
    """A state dict of WavMark's ``Model`` (as :func:`read_state_dict` gives
    it: ``hinet.inv_blocks.{i}.{r,y,f}.conv{1..5}.{weight,bias}``,
    ``watermark_fc.*``, ``watermark_fc_back.*``) -> the state dict of
    ``models`` (a ``WavMarkModels``): a conv's ``weight`` / ``bias`` become
    the port's ``v`` / ``b``, every other leaf keeps its name. A key that
    maps onto no parameter, a parameter no key fills, or a shape that
    differs raises."""
    target = {k: tuple(v.shape) for k, v in models.state_dict().items()}
    out: Dict[str, Array] = {}
    for key, value in sd.items():
        stem, _, leaf = key.rpartition(".")
        if leaf == "weight" and f"{stem}.v" in target:
            out[f"{stem}.v"] = value
        elif leaf == "bias" and f"{stem}.b" in target:
            out[f"{stem}.b"] = value
        else:
            out[key] = value
    extra = sorted(set(out) - set(target))
    if extra:
        raise KeyError(f"WavMark entries no parameter takes: {extra[:5]}")
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"parameters not in the WavMark checkpoint: {missing[:5]}")
    for name, shape in target.items():
        if tuple(out[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != {shape}")
    return out


def load_wavmark(models, path: Union[str, Path]) -> None:
    """Copy WavMark's checkpoint (the released ``Model``'s state dict, as
    ``wavmark.load_model`` reads it) into ``models`` (a ``WavMarkModels``)."""
    import torch

    flat = convert_wavmark(read_state_dict(path), models)
    models.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in flat.items()})
