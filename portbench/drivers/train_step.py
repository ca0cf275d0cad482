"""GAN training steps as the port's training loop makes them: per step the
next batch from ``SyntheticAudioDataset`` (on the loop's prefetch thread),
the controllers' inputs (``step_inputs``), the ``EffectScheduler``'s
attacks, the step's draws (``step_generator``, ``draw``), then
``train.step.train_step``; the scheduler and the controllers are fed the
previous step's metrics (copied back without waiting) while the card runs
the current step. No validation, logging or checkpoints.

Traffic parameters (the workload file): ``checked_steps`` (the steps set-up
drives and the reference follows), ``window_check_step`` (the step of the
window, counted from 0, that the reference takes again; the window lasts
until that step is done, however short ``seconds``), ``profile`` (the
steps of the window the traced run profiles). The batch and clip length
are the configuration's.

Set-up draws the four networks' weights from the seed on the card, loads
them over the state ``create_train_state`` builds, and drives that state
through the first ``checked_steps`` steps, which the window then
continues. Around the window's checked step the state (parameters and
AdamW's moments) is copied to pinned host buffers allocated in set-up,
before the step and the parameters after it, without waiting for the card.
Checked against the plain reference (``reference.train``):

- from the same weights and inputs, over the checked steps:

  - ``loss_gap``, ``disc_loss_gap``: the relative gaps of the first
    step's total generator loss and discriminator loss (the later steps'
    swing on rounding: ``PERF.md``);
  - ``grad_gap``: per leaf, the gap between the norms of the first step's
    gradient as each optimizer got it (its first moment over
    ``1 - beta1``) and the reference's, over the reference leaf's norm or
    the median leaf's, whichever is larger; the median over the leaves
    (single scalar leaves swing on rounding: ``PERF.md``);
  - ``change_gap``: the same for the parameters' change over the checked
    steps, over the leaves that move (:func:`moved`);

- from the program's state before the window's checked step, that step's
  inputs and its update count, over that one step:

  - ``win_loss_gap``, ``win_disc_loss_gap``: the relative gaps of its
    generator and discriminator losses;
  - ``win_change_gap``: as ``change_gap``, for its change.

The detail of a comparison keeps every leaf's gaps and the worst leaf's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pbcore import inputs
from reference import nets
from reference import train as rtrain
from reference.ops import Ops, strict_f32

LIMITS = {"loss_gap": 2e-5, "disc_loss_gap": 1e-3, "grad_gap": 5e-5, "change_gap": 1.5e-3,
          "win_loss_gap": 1e-5, "win_disc_loss_gap": 8e-4, "win_change_gap": 2e-4}
TINY_GRAD = 1e-3
LOSSES = ("loss", "adv/disc_loss")
SNAPSHOT = ("p", "m", "v", "after")


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(c: dict, seed: int):
    """The port's ``TrainConfig`` of a configuration file; unknown keys
    raise."""
    from waveverify_torch import config as pc

    def build(cls, d):
        return cls(**{k: _tuples(v) for k, v in d.items()})

    m = c["model"]
    return pc.TrainConfig(
        generator=build(pc.GeneratorConfig, m["Generator"]),
        detector=build(pc.DetectorConfig, m["Detector"]),
        locator=build(pc.LocatorConfig, m["Locator"]),
        discriminator=build(pc.DiscriminatorConfig, m["Discriminator"]),
        loss=build(pc.LossConfig, c["loss"]), optim=build(pc.OptimConfig, c["optim"]),
        batch_size=c["batch_size"], train_duration=c["train_duration"],
        window_duration=c["window_duration"], remat=c["remat"],
        sub_hop_jitter=c["sub_hop_jitter"], seed=seed)


def weight_spec(model: dict):
    return nets.param_spec(model) + rtrain.disc_spec(model["Discriminator"])


def flax_names(module: torch.nn.Module, prefix: str) -> List[str]:
    """The flax name of each of ``module``'s parameters, in order."""
    out = []
    for full, _ in module.named_parameters():
        *path, name = full.split(".")
        owner = module.get_submodule(".".join(path))
        if isinstance(owner, torch.nn.Linear) and name == "weight":
            name = "kernel"
        out.append("/".join([prefix] + path + [name]))
    return out


def to_flax(kind: str, t: torch.Tensor) -> torch.Tensor:
    """A parameter (or a moment) of the port in the flax layout the
    reference takes, by the leaf's kind in :func:`weight_spec`: 1-D conv
    directions reversed, 2-D ones HWIO, dense kernels transposed, the rest
    (transposed-conv directions among them) as they are. Set-up checks it
    against the weights it loaded."""
    if kind == "conv":
        return t.permute(2, 1, 0)
    if kind == "conv2d":
        return t.permute(2, 3, 1, 0)
    if kind == "dense":
        return t.t()
    return t


def _net(leaf: str) -> str:
    return leaf.split("/")[0]


def net_medians(grads: Dict[str, float]) -> Dict[str, float]:
    """The median leaf's gradient norm of each network (generator,
    detector, locator, discriminator)."""
    by_net: Dict[str, List[float]] = {}
    for k, r in grads.items():
        by_net.setdefault(_net(k), []).append(r)
    return {net: float(np.median(v)) for net, v in by_net.items()}


def moved(grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least ``TINY_GRAD`` of the
    median leaf's of its own network: the others move under AdamW by
    round-off alone."""
    med = net_medians(grads)
    return [k for k, r in grads.items() if r >= TINY_GRAD * med[_net(k)]]


def change_gaps(change: Dict[str, float], ref_change: Dict[str, float],
                ref_grads: Dict[str, float]) -> Dict[str, float]:
    """Per moved leaf, the gap of the change norms over the reference
    leaf's or the median moved leaf's, whichever is larger."""
    keys = moved(ref_grads)
    med = float(np.median([ref_change[k] for k in keys]))
    return {k: abs(change[k] - ref_change[k]) / max(ref_change[k], med) for k in keys}


def left_out(change: Dict[str, float], ref_change: Dict[str, float],
             ref_grads: Dict[str, float]) -> Dict[str, List[float]]:
    """Per leaf that :func:`moved` leaves out and that the reference
    moves: its gradient over its network's median leaf's, and the gap of
    its change norm over its own (how far round-off moves it)."""
    keys = set(moved(ref_grads))
    med = net_medians(ref_grads)
    return {k: [r / med[_net(k)], abs(change[k] - ref_change[k]) / ref_change[k]]
            for k, r in ref_grads.items() if k not in keys and ref_change[k] > 0}


def draws_dict(d) -> dict:
    """A step's draws (the port's ``Draws``) as the reference takes them."""
    return {"loc_scores": d.loc_scores, "loc_probs": d.loc_probs,
            "loc_offset": d.loc_offset, "seq_u": d.seq_u, "seq_shift": d.seq_shift,
            "seq_perm": d.seq_perm, "fx": d.fx, "gp_alpha": d.gp_alpha}


def _move(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _move(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_move(v, dev) for v in x]
    return x


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in d.items()}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.c = ctx.config
        self.dev = torch.device(ctx.device)
        self.cuda = self.dev.type == "cuda"

    # -- the program -----------------------------------------------------------------

    def _state(self, init: Dict[str, torch.Tensor]):
        """The port's ``create_train_state``, with ``init`` (flax-named
        weights) loaded over its own draw."""
        from waveverify_torch.train.state import WM_NETS, create_train_state
        from waveverify_torch.weights import load_params

        state = create_train_state(self.cfg, torch.Generator().manual_seed(self.cfg.seed),
                                   self.dev)
        flat = {k: v.cpu().numpy() for k, v in init.items()}
        consumed = set()
        self.names = {}
        for net in (*WM_NETS, "discriminator"):
            mod = getattr(state.models, net)
            consumed |= load_params(mod, flat, net)
            self.names.update(zip(mod.parameters(), flax_names(mod, net)))
        if consumed != set(flat):
            raise KeyError(f"weights no network takes: {sorted(set(flat) - consumed)[:5]}")
        for p, n in self.names.items():
            if not torch.equal(to_flax(self.kinds[n], p.detach()), init[n]):
                raise ValueError(f"to_flax does not invert the port's layout of {n}")
        return state

    def _params(self):
        """(flax name, parameter, its optimizer) over both optimizers."""
        return [(self.names[p], p, opt) for opt in (self.state.wm_opt, self.state.disc_opt)
                for g in opt.param_groups for p in g["params"]]

    def setup(self) -> None:
        from waveverify_torch.effects.effects import EffectBank
        from waveverify_torch.effects.scheduler import EffectScheduler
        from waveverify_torch.serve import set_conv_precision
        from waveverify_torch.train.data import SyntheticAudioDataset, prefetch_batches
        from waveverify_torch.train.loop import make_controllers

        seed, c, wl = self.ctx.seed, self.c, self.ctx.workload
        self.cfg = cfg = port_config(c, inputs.sub_seed(seed, "train"))
        if self.cuda:
            set_conv_precision("highest")
        self.sr = cfg.generator.sample_rate
        spec = weight_spec(c["model"])
        self.kinds = {n: k for n, _, k in spec}
        init = inputs.make_params(spec, seed, self.dev,
                                  c["model"]["Generator"]["film_gamma_bias"])
        self.state = self._state(init)
        self.init = {k: v.cpu() for k, v in init.items()}
        del init
        self.p0 = {self.names[p]: p.detach().cpu().clone()
                   for p in self.state.models.parameters()}
        self.bank = EffectBank([(e["name"], e["params"]) for e in c["train_effects"]], self.sr)
        sch = c["scheduler"]
        self.scheduler = EffectScheduler(
            effect_params=c["effect_param_grid"], beta=sch["beta"],
            ber_threshold=sch["ber_threshold"], miou_threshold=sch["miou_threshold"],
            rng=np.random.RandomState(inputs.sub_seed(seed, "scheduler")))
        self.ramp, self.curr = make_controllers(cfg)
        self.batches = prefetch_batches(
            SyntheticAudioDataset(cfg.train_duration, self.sr, inputs.sub_seed(seed, "data")),
            cfg.batch_size, cfg.generator.msg_dimension, inputs.sub_seed(seed, "msgs"))
        self.pending = None
        self.recorded = []
        self.port_losses = []
        for s in range(wl["checked_steps"]):
            metrics = self.step(record=self.recorded)
            self.port_losses.append({k: float(metrics[k]) for k in LOSSES})
            if s == 0:
                self.g1 = self._first_grads()
        self.finish_pending()
        self.p3 = {self.names[p]: p.detach().cpu().clone()
                   for p in self.state.models.parameters()}
        self.check_step = wl["window_check_step"]
        self.win_t = wl["checked_steps"] + self.check_step
        self.win_inputs = []
        self.win_host = None
        self._snapshot_buffers()

    def _snapshot_buffers(self) -> None:
        """One pinned host buffer holding, per leaf, the parameter, both
        AdamW moments and the parameter after the window's checked step."""
        leaves = self._params()
        n = sum(p.numel() for _, p, _ in leaves)
        buf = torch.empty(len(SNAPSHOT) * n, pin_memory=self.cuda)
        self.snap = {kind: {} for kind in SNAPSHOT}
        at = 0
        for kind in SNAPSHOT:
            for name, p, _ in leaves:
                self.snap[kind][name] = buf[at:at + p.numel()].view(p.shape)
                at += p.numel()

    def _copy_state(self, kinds) -> None:
        """Queue copies of the state into the snapshot (a leaf without
        optimizer state reads zero moments)."""
        for name, p, opt in self._params():
            st = opt.state.get(p, {})
            for kind in kinds:
                src = {"p": p, "after": p, "m": st.get("exp_avg"),
                       "v": st.get("exp_avg_sq")}[kind]
                if src is None:
                    self.snap[kind][name].zero_()
                else:
                    self.snap[kind][name].copy_(src.detach(), non_blocking=True)

    def _first_grads(self) -> Dict[str, float]:
        """Each leaf's first gradient as its optimizer got it, from the
        optimizer's state: the first moment over 1 - beta1 (0 for a leaf
        the optimizer has no state of)."""
        out = {}
        b1 = self.cfg.optim.beta1
        for name, p, opt in self._params():
            m = opt.state.get(p, {}).get("exp_avg")
            out[name] = 0.0 if m is None else float(torch.linalg.vector_norm(m)) / (1 - b1)
        return out

    def host_inputs(self, step: int):
        """The step's batch, attacks and draws, as the loop makes them."""
        from waveverify_torch.train.loop import step_generator, step_inputs
        from waveverify_torch.train.watermarking import draw

        cfg = self.cfg
        inp = step_inputs(step, self.ramp, self.curr, cfg.loss)
        audio, msg = next(self.batches)
        if inp.fx_on:
            idx, sel = self.scheduler.select_bank_indices(cfg.batch_size, self.bank.specs)
        else:
            idx = np.zeros(cfg.batch_size, np.int32)
            sel = [self.bank.specs[0]] * cfg.batch_size
        draws = draw(step_generator(cfg.seed, step), cfg.batch_size, audio.shape[1],
                     self.bank.draw_specs(idx), self.sr, cfg.window_duration, 0)
        return inp, audio, msg, idx, sel, draws

    def step(self, record: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """One step; with ``record`` its host inputs are appended there."""
        from waveverify_torch.train.step import train_step

        tr = self.ctx.tracer
        state = self.state
        with tr.span("host_inputs"):
            inp, audio, msg, idx, sel, draws = self.host_inputs(state.step)
            if record is not None:
                record.append((audio, msg, idx, draws_dict(draws)))
            bit_mask = (None if inp.bit_mask is None
                        else torch.from_numpy(inp.bit_mask).to(self.dev))
            a = torch.from_numpy(audio).to(self.dev)
            m = torch.from_numpy(msg).to(self.dev)
            d = draws.to(self.dev)
        with tr.span("train_step"):
            metrics = train_step(state, self.cfg, self.bank, a, m, idx, d,
                                 percep_scale=inp.percep_scale, train_disc=inp.train_disc,
                                 gen_update_scale=inp.gen_update_scale,
                                 msg_update_scale=inp.msg_update_scale, bit_mask=bit_mask)
        self.finish_pending()
        with tr.span("readback"):
            host = {k: v.detach().to("cpu", non_blocking=True) for k, v in metrics.items()}
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
            self.pending = (host, sel, event)
        return metrics

    def checked_step(self) -> None:
        """The window's checked step, between copies of the state."""
        tr = self.ctx.tracer
        with tr.span("snapshot"):
            self._copy_state(("p", "m", "v"))
        self.step(record=self.win_inputs)
        self.win_host = self.pending[0]
        with tr.span("snapshot"):
            self._copy_state(("after",))

    def finish_pending(self) -> None:
        """Feed the scheduler and the controllers the last step's metrics,
        waiting for them."""
        if self.pending is None:
            return
        host, sel, event = self.pending
        self.pending = None
        tr = self.ctx.tracer
        if event is not None:
            with tr.span("wait"):
                event.synchronize()
        with tr.span("feed"):
            self._feed(host, sel)

    def _feed(self, host, sel) -> None:
        from waveverify_torch.train.loop import feed_controllers

        bers = np.asarray(host["per_sample_ber"])
        mious = np.asarray(host["per_sample_miou"])
        for i, (name, params) in enumerate(sel[:len(bers)]):
            self.scheduler.update_effect_metrics(
                name, params, float(np.clip(bers[i], 0.0, 1.0)),
                float(np.clip(mious[i], 0.0, 1.0)))
        feed_controllers(self.ramp, self.curr, host["train/ber"].numpy(),
                         host["per_bit_acc"].numpy())

    def run_window(self, seconds: float) -> dict:
        tr = self.ctx.tracer
        t_start = time.perf_counter()
        deadline = t_start + seconds
        steps = 0
        while time.perf_counter() < deadline or steps <= self.check_step:
            tr.iteration(steps)
            if steps == self.check_step:
                self.checked_step()
            else:
                self.step()
            steps += 1
        tr.iteration(steps)
        self.finish_pending()
        t_end = time.perf_counter()
        return {"t_start": t_start, "t_end": t_end, "attempted": steps, "steps": steps}

    def release(self) -> None:
        self.batches.close()
        del self.state, self.names

    # -- the comparison ----------------------------------------------------------------

    def reference_run(self, ops: Ops, count: bool = False) -> dict:
        """The reference over the checked steps from the same weights and
        inputs (its losses, first gradients' and changes' norms by leaf,
        and with ``count`` the FLOP of its first step), and over the
        window's checked step from the program's state before it (its
        losses, gradients' and change's norms by leaf)."""
        from counts import count_flop

        strict_f32()
        ref = rtrain.TrainReference(self.c, _move(self.init, self.dev), ops)
        losses, flop = [], None
        g1 = None
        for s, (audio, msg, idx, d) in enumerate(self.recorded):
            args = (torch.as_tensor(audio, device=self.dev),
                    torch.as_tensor(msg, device=self.dev), idx, _move(d, self.dev))
            if count and s == 0:
                out, flop = count_flop(lambda: ref.step(*args))
            else:
                out = ref.step(*args)
            losses.append({k: out[k] for k in LOSSES})
            if s == 0:
                g1 = _norms(out["grads"])
            del out
        change = {k: float(torch.linalg.vector_norm(ref.p[k].cpu() - self.init[k]))
                  for k in ref.p}
        result = {"losses": losses, "g1": g1, "change": change, "flop": flop}
        del ref
        if self.win_inputs:
            result.update(self._reference_window(ops))
        return result

    def _reference_window(self, ops: Ops) -> dict:
        kinds = self.kinds
        before = {n: to_flax(kinds[n], t).to(self.dev) for n, t in self.snap["p"].items()}
        ref = rtrain.TrainReference(self.c, before, ops)
        for opt in (ref.wm_opt, ref.disc_opt):
            opt.t = self.win_t
            for n in opt.names:
                opt.m[n].copy_(to_flax(kinds[n], self.snap["m"][n]))
                opt.v[n].copy_(to_flax(kinds[n], self.snap["v"][n]))
        audio, msg, idx, d = self.win_inputs[0]
        out = ref.step(torch.as_tensor(audio, device=self.dev),
                       torch.as_tensor(msg, device=self.dev), idx, _move(d, self.dev))
        change = {n: float(torch.linalg.vector_norm(ref.p[n] - before[n])) for n in before}
        return {"win_losses": {k: out[k] for k in LOSSES}, "win_change": change,
                "win_grads": _norms(out["grads"])}

    def judge(self, got: dict, ref: dict) -> dict:
        """The numbers compared, for the program's (or the control's)
        readings ``got`` against the reference's ``ref``; a window step the
        program never took reads infinite gaps."""
        loss_gaps = {f"{k}@{s + 1}": abs(a[k] - b[k]) / abs(b[k])
                     for s, (a, b) in enumerate(zip(got["losses"], ref["losses"])) for k in b}
        med_g = float(np.median(list(ref["g1"].values())))
        grad_gaps = {k: abs(got["g1"][k] - r) / max(r, med_g) for k, r in ref["g1"].items()}
        chg = change_gaps(got["change"], ref["change"], ref["g1"])
        values = {
            "loss_gap": loss_gaps["loss@1"],
            "disc_loss_gap": loss_gaps["adv/disc_loss@1"],
            "grad_gap": float(np.median(list(grad_gaps.values()))),
            "change_gap": float(np.median(list(chg.values()))),
        }
        detail = {"loss_gaps": loss_gaps, "grad_gaps": grad_gaps, "change_gaps": chg,
                  "worst_grad_gap": max(grad_gaps.values()),
                  "worst_change_gap": max(chg.values())}
        if got.get("win_losses") is not None and "win_losses" in ref:
            win_chg = change_gaps(got["win_change"], ref["win_change"], ref["win_grads"])
            for k, name in zip(LOSSES, ("win_loss_gap", "win_disc_loss_gap")):
                b = ref["win_losses"][k]
                values[name] = abs(got["win_losses"][k] - b) / abs(b)
            values["win_change_gap"] = float(np.median(list(win_chg.values())))
            detail.update(win_change_gaps=win_chg, worst_win_change_gap=max(win_chg.values()),
                          win_moved=len(win_chg), win_leaves=len(ref["win_grads"]))
        else:
            values.update(win_loss_gap=float("inf"), win_disc_loss_gap=float("inf"),
                          win_change_gap=float("inf"))
        detail.update(moved=len(chg), leaves=len(ref["g1"]),
                      left_out=left_out(got["change"], ref["change"], ref["g1"]))
        checks = [{"name": n, "value": v, "limit": LIMITS[n]} for n, v in values.items()]
        return {"correct": all(c["value"] <= c["limit"] for c in checks), "checks": checks,
                "detail": detail}

    def program_readings(self) -> dict:
        """The program's losses, first gradients and changes over the
        checked steps, and its losses and change at the window's checked
        step (None where it took none)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {"losses": self.port_losses, "g1": self.g1,
               "change": {k: float(torch.linalg.vector_norm(v - self.p0[k]))
                          for k, v in self.p3.items()},
               "win_losses": None}
        if self.win_host is not None:
            out["win_losses"] = {k: float(self.win_host[k]) for k in LOSSES}
            out["win_change"] = {n: float(torch.linalg.vector_norm(a - self.snap["p"][n]))
                                 for n, a in self.snap["after"].items()}
        return out

    def check(self, count: bool = False) -> dict:
        self.ref = self.reference_run(Ops(), count=count)
        out = self.judge(self.program_readings(), self.ref)
        out["flop"] = self.ref["flop"]
        return out

    def control_check(self) -> dict:
        """:meth:`check` of the control: the reference in TF32 in the
        program's place (from the same start at the window's step)."""
        if not hasattr(self, "ref"):
            self.ref = self.reference_run(Ops())
        return self.judge(self.reference_run(Ops(tf32=True)), self.ref)
