"""Persistent LSTM recurrence: the CUDA kernel, its launch plan, and its
plain PyTorch version.

The kernel is ``csrc/lstm_recurrence.cu`` (see its header for the design).
It replaces no TPU kernel: it runs the LSTM bottleneck of AudioSeal's
audiocraft SEANet (``modules/audiocraft.py`` ``StreamableLSTM``), which
cuDNN ran as a gemv and an elementwise kernel per frame and layer.

One LSTM call over ``seq [T, B, H]`` (input width = hidden width H, as
``StreamableLSTM`` builds it) with the weights of ``torch.nn.LSTM`` (gate
order i, f, g, o; ``weight_ih``, ``weight_hh`` of shape ``[4H, H]``; both
biases):

1. layer 0's input product over all frames, ``seq W_ih0^T + b_ih0 + b_hh0``,
   as one f32 GEMM (``torch.addmm``);
2. every frame of every layer in one cooperative launch: CTA k of layer l
   owns ``units[l]`` hidden units and keeps their gate rows of the weights
   in shared memory; layers run as a pipeline, each a frame behind the one
   below at most (the wavefront of :func:`lstm_plan`). Where the layers'
   weights do not fit the card's shared memory together (or there are more
   than ``MAX_LAYERS``), there is no plan (None) and the caller keeps
   cuDNN.

The plan depends on H, the number of layers and the card (its SM count and
shared memory per block) alone; T and B are the launch's arguments, and a
batch over what one launch's shared memory holds for the cell state runs
in several launches of whole batch rows.

Dispatch is by the tensor's device: a CPU tensor goes to
:func:`lstm_recurrence_ref`; a CUDA tensor goes to the kernel, or the call
raises. The library is built with ``nvcc`` on first use, from the source
in this checkout, into ``build/kernels/`` beside the package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from waveverify_torch import spans
from waveverify_torch.ops import nvcc

# The kernel's compile-time shape (kThreads, kRows, kGroup, kMaxLayers,
# kCounterStride, kMaxOut in the source).
THREADS = 384
ROWS_PER_THREAD = 4
BATCH_GROUP = 8
MAX_LAYERS = 4
_COUNTER_STRIDE = 32
_MAX_OUT = 2
# Units per CTA: its 4 U gate rows x 8 batch rows are reduced by at most
# _MAX_OUT sums a thread, and its U x 8 cells take a thread each.
MAX_UNITS = min(_MAX_OUT * THREADS // (4 * BATCH_GROUP), THREADS // BATCH_GROUP)
# An H100 SXM's SMs and shared memory per block (opt-in maximum), the
# plan's defaults off the card.
H100_SMS = 132
H100_SMEM = 232448
# A wait for another CTA longer than this traps (a fault, not a slow card).
_SPIN_NS = 10 ** 10

SPAN = "lstm.persistent"

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "lstm_recurrence.cu"

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


# --------------------------------------------------------------------------
# launch plan
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LstmPlan:
    """How one LSTM call runs, every layer in one launch: per layer the
    hidden units each CTA owns and the CTAs; the launch's shared memory per
    CTA for one batch group; the batch rows one launch holds."""

    units: Tuple[int, ...]
    ctas: Tuple[int, ...]
    smem: int
    max_batch: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def geometry(h: int, units: int) -> Tuple[int, int, int, int]:
    """``(slices, quads, padded, pstride)`` of a CTA of ``units`` units (the
    source's ``Geometry``): thread (s, rg) sums rows 4 rg .. 4 rg + 3 over
    k-slice s of each H-long half; k runs in quads of 4 and slice s owns
    quads s, s + slices, ..., ``quads`` of them (the fewest that the
    threads allow, then the fewest slices that cover H); H is zero-padded
    to ``padded``; the partial sums' rows are ``pstride`` floats, = units
    mod 32."""
    nq = _ceil(h, 4)
    quads = _ceil(nq, THREADS // units)
    slices = _ceil(nq, quads)
    return slices, quads, 4 * slices * quads, slices * units + (units - slices * units % 32) % 32


def layer_smem(h: int, layer: int, units: int, batch: int) -> Tuple[int, int, int, int]:
    """Floats of shared memory of a CTA of ``layer`` in a launch (the
    source's ``layer_smem``): its weights ``[half][quad][4][slice][units][4]``
    (one H-long half for layer 0, two above it), the union of the staged h
    ``[half][8][padded]`` and the partial sums ``[32][pstride]``, the gate
    sums ``[8][4 units]``, and c for ``batch`` rows."""
    _, _, padded, pstride = geometry(h, units)
    halves = 1 if layer == 0 else 2
    ws = halves * padded * 4 * units
    uni = max(halves * BATCH_GROUP * padded, ROWS_PER_THREAD * BATCH_GROUP * pstride)
    gs = BATCH_GROUP * 4 * units
    cs = _ceil(units * batch, 4) * 4
    return ws, uni, gs, cs


def smem_bytes(h: int, units: Sequence[int], batch: int = BATCH_GROUP) -> int:
    """Bytes of dynamic shared memory of a launch whose layers own
    ``units`` units per CTA: each part at its largest over the layers."""
    parts = [layer_smem(h, layer, u, batch) for layer, u in enumerate(units)]
    return 4 * sum(max(p[i] for p in parts) for i in range(4))


def _fit(h: int, units: Tuple[int, ...], sms: int, smem: int) -> Optional[LstmPlan]:
    """The launch of ``units`` if its CTAs fit one per SM and their shared
    memory fits, else None; ``max_batch`` is the most batch rows, a
    multiple of 8, whose cell state fits beside the rest."""
    ctas = tuple(_ceil(h, u) for u in units)
    need = smem_bytes(h, units)
    if max(units) > MAX_UNITS or sum(ctas) > sms or need > smem:
        return None
    rows = BATCH_GROUP + (smem - need) // (4 * max(units)) // BATCH_GROUP * BATCH_GROUP
    while smem_bytes(h, units, rows) > smem:
        rows -= BATCH_GROUP
    return LstmPlan(units, ctas, need, rows)


@functools.lru_cache(maxsize=None)
def lstm_plan(h: int, layers: int, sms: int = H100_SMS,
              smem: int = H100_SMEM) -> Optional[LstmPlan]:
    """The plan for an LSTM of ``layers`` layers of width ``h`` on a card of
    ``sms`` SMs with ``smem`` bytes of shared memory per block.

    A layer's CTA does 4 U K f32 FMA per batch row and frame (K = H for
    layer 0, whose input product is precomputed; 2H above it), so layers
    above the first take half the units of the first, which balances the
    CTAs' work. The fewest units per CTA whose CTAs all fit one per SM win:
    the most SMs share a frame's work. None where the layers (at most
    ``MAX_LAYERS``) do not fit one launch that way."""
    if layers > MAX_LAYERS:
        return None
    for u in range(1, min(h, MAX_UNITS) + 1):
        units = (min(h, 2 * u, MAX_UNITS),) + (u,) * (layers - 1) if layers > 1 else (u,)
        plan = _fit(h, units, sms, smem)
        if plan is not None:
            return plan
    return None


def device_plan(device: torch.device, h: int, layers: int) -> Optional[LstmPlan]:
    """:func:`lstm_plan` for the card ``device``."""
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin", H100_SMEM)
    return lstm_plan(h, layers, props.multi_processor_count, smem)


def unit_slices(h: int, units: int) -> List[Tuple[int, int]]:
    """``(first unit, units)`` of each CTA of a layer: the last may own fewer."""
    return [(u0, min(units, h - u0)) for u0 in range(0, h, units)]


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------


def _input_product(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                   b_hh: torch.Tensor) -> torch.Tensor:
    """``x [T, B, H] W_ih^T + b_ih + b_hh`` as one GEMM over all frames."""
    t, b, h = x.shape
    return torch.addmm(b_ih + b_hh, x.reshape(t * b, h), w_ih.t()).view(t, b, -1)


def _gate_sums(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], units: int
               ) -> torch.Tensor:
    """``sum over (w, h) of h [B, H] w^T`` as the kernel's threads sum it:
    k-slice s (of :func:`geometry`: quads s, s + slices, ... of 4 k) of
    every pair into one partial sum, the slices' sums in four chains by
    s mod 4, then the chains pairwise."""
    x = pairs[0][1]
    slices, quads, padded, _ = geometry(x.shape[1], units)
    chains = [x.new_zeros(x.shape[0], pairs[0][0].shape[0]) for _ in range(4)]
    for s in range(slices):
        part = 0
        for w, h in pairs:
            pad = padded - h.shape[1]
            hq = torch.nn.functional.pad(h, (0, pad)).view(h.shape[0], quads, slices, 4)
            wq = torch.nn.functional.pad(w, (0, pad)).view(w.shape[0], quads, slices, 4)
            part = part + hq[:, :, s].reshape(h.shape[0], -1) @ wq[:, :, s].reshape(
                w.shape[0], -1).t()
        chains[s % 4] = chains[s % 4] + part
    return (chains[0] + chains[1]) + (chains[2] + chains[3])


def lstm_recurrence_ref(seq: torch.Tensor, weights: Weights,
                        plan: Optional[LstmPlan] = None) -> torch.Tensor:
    """The LSTM's output ``[T, B, H]`` of ``seq [T, B, H]``, computed as the
    kernel computes it, in f32, with the partition of ``plan`` (default: the
    H100's :func:`lstm_plan`): the first layer's input product as one GEMM,
    then the frames in wavefront order (step s runs frame s - i of layer
    i), each layer's gates per CTA of its unit partition: per k-slice the
    input half's and then the recurrent half's products into one sum, the
    slices' sums in four chains (:func:`_gate_sums`), then the product or
    the bias."""
    t_len, batch, h = seq.shape
    layers = len(weights)
    plan = plan or lstm_plan(h, layers)
    if plan is None:
        raise ValueError(f"no plan for H={h}, {layers} layers")
    x = seq.float()
    pre = _input_product(x, weights[0][0], *weights[0][2:])
    outs = [x.new_zeros(t_len, batch, h) for _ in range(layers)]
    cells = [x.new_zeros(batch, h) for _ in range(layers)]
    for s in range(t_len + layers - 1):
        for i in range(layers):
            t = s - i
            if not 0 <= t < t_len:
                continue
            w_ih, w_hh, b_ih, b_hh = (w.float() for w in weights[i])
            gates = x.new_zeros(batch, 4 * h)
            for u0, nu in unit_slices(h, plan.units[i]):
                rows = torch.cat([torch.arange(g * h + u0, g * h + u0 + nu,
                                               device=x.device) for g in range(4)])
                pairs = []
                if i > 0:  # the input half, then the recurrent half
                    pairs.append((w_ih[rows], outs[i - 1][t]))
                if t > 0:
                    pairs.append((w_hh[rows], outs[i][t - 1]))
                part = _gate_sums(pairs, plan.units[i]) if pairs else 0
                base = pre[t][:, rows] if i == 0 else (b_ih + b_hh)[rows]
                gates[:, rows] = part + base
            gi, gf, gg, go = gates.chunk(4, dim=1)
            cells[i] = torch.sigmoid(gf) * cells[i] + torch.sigmoid(gi) * torch.tanh(gg)
            outs[i][t] = torch.sigmoid(go) * torch.tanh(cells[i])
    return outs[-1]


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------

_LIB = None


def build() -> Path:
    """The kernel library, compiled for sm_90a on first use
    (:func:`waveverify_torch.ops.nvcc.build`). Returns its path."""
    return nvcc.build(_SOURCE)


def bind(path: Path):
    """The kernel library at ``path``, its functions' argument types set."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp, ip = ctypes.POINTER(p), ctypes.POINTER(i)
    lib.wv_lstm_recurrence.argtypes = [p, pp, pp, pp, pp, pp, p, i, i, i, i, i, ip, ip, ll, p]
    lib.wv_lstm_recurrence.restype = i
    lib.wv_lstm_smem_bytes.argtypes = [i, i, ip, i]
    lib.wv_lstm_smem_bytes.restype = i
    lib.wv_lstm_error_string.argtypes = [i]
    lib.wv_lstm_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = bind(build())
    return _LIB


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: " + lib.wv_lstm_error_string(err).decode())


def kernel_smem_bytes(h: int, units: Sequence[int], batch: int) -> int:
    """The source's count of a launch's shared memory. Needs the card's
    library."""
    import ctypes

    return _library().wv_lstm_smem_bytes(h, len(units), (ctypes.c_int * len(units))(*units),
                                         batch)


def _ptrs(tensors: Sequence[Optional[torch.Tensor]]):
    import ctypes

    return (ctypes.c_void_p * len(tensors))(*[0 if t is None else t.data_ptr()
                                              for t in tensors])


def _launch(pre: torch.Tensor, weights: Weights, outs: Sequence[torch.Tensor],
            counters: torch.Tensor, b0: int, nb: int, plan: LstmPlan) -> None:
    """One cooperative launch: every layer over batch rows ``[b0, b0 +
    nb)``."""
    import ctypes

    lib = _library()
    t_len, batch, h = outs[0].shape
    n = len(weights)
    with torch.cuda.device(pre.device):
        err = lib.wv_lstm_recurrence(
            pre[:, b0:].data_ptr(),
            _ptrs([None] + [w[0] for w in weights[1:]]), _ptrs([w[1] for w in weights]),
            _ptrs([None] + [w[2] for w in weights[1:]]),
            _ptrs([None] + [w[3] for w in weights[1:]]),
            _ptrs([o[:, b0:] for o in outs]), counters.data_ptr(), t_len, nb, batch, h, n,
            (ctypes.c_int * n)(*plan.units), (ctypes.c_int * n)(*plan.ctas), _SPIN_NS,
            torch.cuda.current_stream(pre.device).cuda_stream)
    _raise(lib, err, "lstm_recurrence kernel launch")
    lstm_recurrence.launches += 1


def _check(seq: torch.Tensor, weights: Weights) -> None:
    """Raise on what the kernel does not take."""
    if seq.dim() != 3 or seq.dtype != torch.float32:
        raise ValueError(f"seq must be f32 [T, B, H], got {seq.dtype} {tuple(seq.shape)}")
    h = seq.shape[2]
    for layer in weights:
        if len(layer) != 4:
            raise ValueError("each layer needs w_ih, w_hh, b_ih, b_hh")
        w_ih, w_hh, b_ih, b_hh = layer
        if w_ih.shape != (4 * h, h) or w_hh.shape != (4 * h, h) or b_ih.shape != (4 * h,) \
                or b_hh.shape != (4 * h,):
            raise ValueError(f"weights must be [4H, H] and [4H] for H={h}")
        for w in layer:
            if w.dtype != torch.float32 or not w.is_contiguous() or w.device != seq.device:
                raise ValueError("weights must be contiguous f32 on the input's device")


def _run(seq: torch.Tensor, weights: Weights, plan: LstmPlan) -> torch.Tensor:
    """The kernel on a CUDA tensor: the first layer's input product, then
    one launch per ``plan.max_batch`` batch rows."""
    _check(seq, weights)
    batch = seq.shape[1]
    x = seq.contiguous()
    pre = _input_product(x, weights[0][0], *weights[0][2:])
    outs = [torch.empty_like(x) for _ in weights]
    chunks = range(0, batch, plan.max_batch)
    counters = torch.zeros(len(chunks), len(weights) * _COUNTER_STRIDE, dtype=torch.int32,
                           device=x.device)
    with spans.span(SPAN):
        for n, b0 in enumerate(chunks):
            _launch(pre, weights, outs, counters[n], b0, min(plan.max_batch, batch - b0),
                    plan)
    return outs[-1]


def lstm_recurrence(seq: torch.Tensor, weights: Weights,
                    plan: Optional[LstmPlan] = None) -> torch.Tensor:
    """The output ``[T, B, H]`` of an LSTM of ``len(weights)`` layers over
    ``seq [T, B, H]`` from zero state; ``weights`` holds each layer's
    ``(w_ih, w_hh, b_ih, b_hh)`` as ``torch.nn.LSTM`` keeps them.

    CPU tensors take :func:`lstm_recurrence_ref`. CUDA tensors take the
    kernel, one launch per ``plan.max_batch`` batch rows (default plan:
    :func:`device_plan`), or raise where no plan fits; ``launches`` counts
    kernel launches."""
    if seq.device.type == "cpu":
        return lstm_recurrence_ref(seq, weights, plan)
    if seq.device.type != "cuda":
        raise RuntimeError(f"lstm_recurrence: unsupported device {seq.device}")
    plan = plan or device_plan(seq.device, seq.shape[2], len(weights))
    if plan is None:
        raise ValueError(f"no plan fits H={seq.shape[2]}, {len(weights)} layers on this card")
    return _run(seq, weights, plan)


lstm_recurrence.launches = 0

