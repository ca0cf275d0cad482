"""Carry weights from the JAX package's formats into the port's modules.

The ``.npz`` written by ``save_weights_npz`` holds f16 arrays under
'/'-joined flax paths plus a ``__config__`` JSON snapshot. It is read with
numpy alone and upcast to f32 as ``load_weights_npz`` does. The port's
modules carry the flax names, so a path maps onto a parameter by replacing
'/' with '.'; only the layouts change:

- conv ``v``: WIO ``(K, Cin / g, Cout)`` -> torch ``(Cout, Cin / g, K)``;
- transposed-conv ``v``: already ``(Cin, Cout / g, K)``;
- 2-D conv ``v`` (the discriminator's): HWIO ``(Kh, Kw, Cin / g, Cout)`` ->
  OIHW ``(Cout, Cin / g, Kh, Kw)``;
- Dense ``kernel (in, out)`` -> ``Linear.weight (out, in)``; ``bias`` as is.

:func:`export_params` is the inverse map (port -> flax paths and layouts),
and :func:`write_npz` writes the ``save_weights_npz`` format, so weights
carry across both ways.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Set, Tuple, Union

import numpy as np
import torch
from torch import nn

from waveverify_torch.modules.conv import NormConv1d, NormConv2d


def read_npz(path: Union[str, Path]) -> Tuple[Dict[str, np.ndarray],
                                               Optional[Dict[str, Any]]]:
    """(flat f32 arrays by flax path, model-config snapshot or None)."""
    with np.load(Path(path)) as z:
        flat = {k: np.asarray(z[k], np.float32) for k in z.files
                if not k.startswith("__")}
        snap = (json.loads(bytes(z["__config__"]).decode())
                if "__config__" in z.files else None)
    return flat, snap


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax params dict (numpy leaves) -> '/'-joined flat dict."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value, np.float32)
    return out


def _to_torch_layout(owner: nn.Module, name: str,
                     value: np.ndarray) -> Tuple[str, np.ndarray]:
    if isinstance(owner, NormConv1d) and name == "v":
        return name, np.transpose(value, (2, 1, 0))
    if isinstance(owner, NormConv2d) and name == "v":
        return name, np.transpose(value, (3, 2, 0, 1))
    if isinstance(owner, nn.Linear) and name == "kernel":
        return "weight", value.T
    return name, value


def _to_flax_layout(owner: nn.Module, name: str,
                    value: np.ndarray) -> Tuple[str, np.ndarray]:
    if isinstance(owner, NormConv1d) and name == "v":
        return name, np.transpose(value, (2, 1, 0))
    if isinstance(owner, NormConv2d) and name == "v":
        return name, np.transpose(value, (2, 3, 1, 0))
    if isinstance(owner, nn.Linear) and name == "weight":
        return "kernel", value.T
    return name, value


def export_params(module: nn.Module, prefix: str) -> Dict[str, np.ndarray]:
    """Every parameter of ``module`` as f32 numpy under its '/'-joined flax
    path below ``prefix``, in the flax layout (the inverse of
    :func:`load_params`)."""
    out: Dict[str, np.ndarray] = {}
    for full, p in module.named_parameters():
        *path, name = full.split(".")
        owner = module.get_submodule(".".join(path))
        # a copy: on the CPU .numpy() would alias the live parameter
        name, arr = _to_flax_layout(owner, name,
                                    p.detach().float().cpu().numpy().copy())
        out["/".join([prefix] + path + [name])] = np.ascontiguousarray(arr)
    return out


def write_npz(path: Union[str, Path], flat: Mapping[str, np.ndarray],
              snapshot: Optional[Dict[str, Any]] = None,
              dtype=np.float16) -> Path:
    """Write ``flat`` (flax paths) as a ``save_weights_npz`` file: values
    cast to ``dtype``, the model-config ``snapshot`` as JSON bytes under
    ``__config__``."""
    arrays = {k: np.asarray(v).astype(dtype) for k, v in flat.items()}
    if snapshot is not None:
        arrays["__config__"] = np.frombuffer(json.dumps(snapshot).encode(),
                                             dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_params(module: nn.Module, flat: Mapping[str, np.ndarray],
                prefix: str) -> Set[str]:
    """Copy every ``flat`` entry under ``prefix/`` into ``module``.

    Returns the keys consumed. Raises if an entry names no parameter, if a
    shape disagrees, or if a parameter of ``module`` is left unset."""
    params = dict(module.named_parameters())
    consumed: Set[str] = set()
    seen: Set[str] = set()
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        path = key[len(prefix) + 1:].split("/")
        owner = module.get_submodule(".".join(path[:-1]))
        name, arr = _to_torch_layout(owner, path[-1], value)
        full = ".".join(path[:-1] + [name])
        if full not in params:
            raise KeyError(f"{key}: no parameter {full} in {type(module).__name__}")
        p = params[full]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr, np.float32)))
        consumed.add(key)
        seen.add(full)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"parameters not in the checkpoint under {prefix}/: {missing}")
    return consumed
