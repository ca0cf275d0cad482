"""What a run makes from its seed: sub-seeds, clips, ids and weights.

Every draw of a run comes from ``--seed`` through :func:`sub_seed`, one
stream per purpose, so a seed gives the same inputs on every machine and
seeds of any size (the driver's exceed 32 bits) are taken whole.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 32-bit seed for ``purpose``, a function of (seed, purpose) alone."""
    words = [int(b) for b in purpose.encode()]
    return int(np.random.SeedSequence([seed % 2 ** 64, *words]).generate_state(1)[0])


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose))


def speech_like(g: np.random.Generator, n: int, t: int, sr: int) -> np.ndarray:
    """``[n, t]`` float32 clips: five drifting harmonics of a 80-300 Hz
    pitch, pink-ish noise, a random level, peaks at most 0.5."""
    tt = (np.arange(t, dtype=np.float32) / sr)[None, None, :]
    f0 = g.uniform(80, 300, (n, 1, 1)).astype(np.float32)
    h = np.arange(1, 6, dtype=np.float32)[None, :, None]
    drift = 1.0 + 0.01 * np.sin(2 * np.pi * g.uniform(0.5, 3, (n, 5, 1)).astype(np.float32) * tt)
    amp = g.uniform(0.2, 1.0, (n, 5, 1)).astype(np.float32) / h
    phase = g.uniform(0, 2 * np.pi, (n, 5, 1)).astype(np.float32)
    x = (amp * np.sin(2 * np.pi * f0 * h * drift * tt + phase)).sum(axis=1)
    pink = np.cumsum(g.standard_normal((n, t), dtype=np.float32), axis=1)
    ramp = np.linspace(0.0, 1.0, t, dtype=np.float32)[None, :]
    pink -= pink[:, :1] + (pink[:, -1:] - pink[:, :1]) * ramp
    pink /= np.abs(pink).max(axis=1, keepdims=True) + 1e-9
    x = x + 0.05 * pink
    x *= 0.5 / (np.abs(x).max(axis=1, keepdims=True) + 1e-9)
    level = (0.3 + 0.7 * g.random((n, 1))).astype(np.float32)
    return (x * level).astype(np.float32)


def bits(g: np.random.Generator, n: int, nbits: int = 16) -> np.ndarray:
    """``[n, nbits]`` random ids as float32 {0, 1}."""
    return g.integers(0, 2, (n, nbits)).astype(np.float32)


def make_params(spec: Iterable[Tuple[str, Tuple[int, ...], str]], seed: int,
                device: torch.device, film_gamma_bias: float = 0.0
                ) -> Dict[str, torch.Tensor]:
    """Float32 weights for ``spec`` (name, shape, draw), drawn on ``device``
    by one generator in one normal draw:

    - ``conv`` / ``convtr`` / ``conv2d``: N(0, 1 / fan_in), fan_in the
      product of the kernel's sizes over the input channels and taps;
    - ``dense``: N(0, 0.02^2), clipped at two deviations;
    - ``normal``: N(0, 1);
    - ``norm``: a weight norm's gain, the norm of the ``v`` beside it (so
      the effective kernel is ``v``);
    - ``zero``: zeros; ``film_gamma``: ``film_gamma_bias``."""
    spec = list(spec)
    drawn = [(n, s, k) for n, s, k in spec
             if k in ("conv", "convtr", "conv2d", "dense", "normal")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in drawn:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if kind == "conv":        # (K, Cin / g, Cout)
            v = v / math.sqrt(shape[0] * shape[1])
        elif kind == "convtr":    # (Cin, Cout / g, K)
            v = v / math.sqrt(shape[1] * shape[2])
        elif kind == "conv2d":    # (Kh, Kw, Cin / g, Cout)
            v = v / math.sqrt(shape[0] * shape[1] * shape[2])
        elif kind == "dense":
            v = torch.clamp(v, -2.0, 2.0) * 0.02
        out[name] = v
    kinds = {name: kind for name, _, kind in spec}
    for name, shape, kind in spec:
        if kind == "norm":
            vname = name[:-2] + "/v"
            v = out[vname]
            # a transposed conv keeps its input channels first; the others
            # their output channels last
            dims = ((1, 2) if kinds[vname] == "convtr"
                    else tuple(range(v.dim() - 1)))
            out[name] = torch.sqrt(torch.sum(v * v, dim=dims))
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "film_gamma":
            out[name] = torch.full(shape, float(film_gamma_bias), device=device)
    return {name: out[name].contiguous() for name, _, _ in spec}
