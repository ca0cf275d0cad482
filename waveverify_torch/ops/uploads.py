"""Host-to-device uploads that do not make the host wait.

A copy from pageable host memory returns only once the stream has drained,
so every such copy inside a step lets the card idle until the host has
enqueued the work behind it again. The port's uploads take one of two forms
here instead:

- :data:`device_const`: a constant the host builds in numpy (a DFT basis, a
  window, a filter kernel, a filter bank) is uploaded once per device and
  dtype and kept; later calls return the kept tensor;
- :func:`upload_rows`: indices that change every call go to a card from
  pinned memory, without blocking.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

import numpy as np
import torch

from waveverify_torch import spans


class DeviceConsts:
    """Constants built on the host, kept on each device in each dtype.

    ``device_const(builder, *params, like=x)`` is ``torch.as_tensor(
    builder(*params), dtype=x.dtype, device=x.device)``, built and uploaded
    the first time (a miss, recorded as the span ``dev_const.upload``) and
    returned from the cache after that (a hit). The key is the builder, its
    parameters (hashable: numbers, strings, bytes, tuples), the device and
    the dtype, never an array's identity. The values are what a fresh
    ``torch.as_tensor`` of the builder gives, bit for bit.

    The kept tensors are shared by every caller: they hold no gradient and
    must never be written in place. A miss builds outside any inference
    mode, so a constant first made there still serves autograd later.
    """

    def __init__(self):
        self._cache: Dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()  # autograd's device thread calls too
        self.hits = 0
        self.misses = 0

    def __call__(self, builder: Callable[..., np.ndarray], *params,
                 like: torch.Tensor) -> torch.Tensor:
        key = (builder, params, like.device, like.dtype)
        with self._lock:
            t = self._cache.get(key)
            if t is not None:
                self.hits += 1
                return t
            self.misses += 1
            with spans.span("dev_const.upload"), torch.inference_mode(False):
                t = torch.as_tensor(builder(*params), dtype=like.dtype,
                                    device=like.device)
            self._cache[key] = t
            return t

    def stats(self) -> Dict[str, int]:
        """The hits and misses so far, and the entries kept."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._cache)}


device_const = DeviceConsts()


def upload_rows(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host indices ``rows`` as an int64 tensor on ``device``. To a card
    the copy goes from pinned memory and returns without waiting:
    PyTorch's caching host allocator keeps the pinned buffer until the
    copy has run. On the CPU it is the array itself."""
    t = torch.from_numpy(np.asarray(rows, np.int64))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
