"""Plain reference of one GAN training step of WaveVerify (``conf/base.yml``
at ``TrainConfig()``): the composite forward (generator, localization and
sequence augmentations, the attack bank, detector, locator), the
discriminator update (LSGAN plus the WGAN-GP gradient penalty, gradients
clipped at 10, AdamW), the generator losses against the updated
discriminator (multi-scale STFT, mel, L1 waveform, LSGAN, decoding and
localization BCE), the generator's gradients clipped at 10, and AdamW on
the three watermarking networks, each optimizer with its exponential
learning-rate decay.

State is a flat dict of flax-named float32 tensors (``nets.param_spec`` and
:func:`disc_spec` name them) with AdamW's moments beside it. A step takes
the batch, the message, each sample's attack (an index into the config's
``train_effects``) and the step's random draws, all made outside.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import dsp, nets
from reference.ops import Ops

Params = Dict[str, torch.Tensor]

LRELU = 0.1
MRD_SPECS = [((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 3), (1, 1), (1, 1))]
MPD_CHANNELS = [(1, 32), (32, 128), (128, 512), (512, 1024)]
MAX_GRAD_NORM = 10.0
WEIGHT_DECAY = 0.01
ADAM_EPS = 1e-8


# -- discriminator -----------------------------------------------------------------


def disc_spec(d: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, flax HWIO shape, initial draw) of the discriminator's weights."""
    out = []

    def conv2d(name, kh, kw, cin, cout):
        out.extend([(name + "/v", (kh, kw, cin, cout), "conv2d"),
                    (name + "/g", (cout,), "norm"), (name + "/b", (cout,), "zero")])

    for i, _ in enumerate(d["periods"]):
        for j, (cin, cout) in enumerate(MPD_CHANNELS):
            conv2d(f"discriminator/mpd_{i}/conv_{j}", 5, 1, cin, cout)
        conv2d(f"discriminator/mpd_{i}/conv_4", 5, 1, 1024, 1024)
        conv2d(f"discriminator/mpd_{i}/conv_post", 3, 1, 1024, 1)
    for i, _ in enumerate(d["fft_sizes"]):
        for bi in range(len(d["bands"])):
            cin = 2
            for ci, (k, _s, _p) in enumerate(MRD_SPECS):
                conv2d(f"discriminator/mrd_{i}/band_{bi}_conv_{ci}", k[0], k[1], cin, 32)
                cin = 32
        conv2d(f"discriminator/mrd_{i}/conv_post", 3, 3, 32, 1)
    return out


def _conv2d(ops: Ops, p: Params, pre: str, x: torch.Tensor, stride, padding):
    w = nets.wn_weight(p, pre, (0, 1, 2)).permute(3, 2, 0, 1)
    return ops.conv2d(x, w, p[pre + "/b"], stride=stride, padding=padding)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU)


def discriminator(ops: Ops, p: Params, d: dict, audio: torch.Tensor
                  ) -> List[List[torch.Tensor]]:
    """audio ``[B, T]`` -> per sub-discriminator its feature maps, the logit
    map last: one MPD per period, one MRD per FFT size."""
    x = audio - torch.mean(audio, dim=-1, keepdim=True)
    x = 0.8 * x / (torch.amax(torch.abs(x), dim=-1, keepdim=True) + 1e-9)
    out = []
    t = x.shape[-1]
    for i, period in enumerate(d["periods"]):
        pre = f"discriminator/mpd_{i}"
        y = F.pad(x[:, None, :], (0, period - t % period), mode="reflect")
        y = y.reshape(y.shape[0], 1, -1, period)
        maps = []
        for j in range(5):
            y = _lrelu(_conv2d(ops, p, f"{pre}/conv_{j}", y,
                               (3, 1) if j < 4 else (1, 1), (2, 0)))
            maps.append(y)
        maps.append(_conv2d(ops, p, f"{pre}/conv_post", y, (1, 1), (1, 0)))
        out.append(maps)
    for i, n_fft in enumerate(d["fft_sizes"]):
        pre = f"discriminator/mrd_{i}"
        re, im = dsp.stft_match_stride(ops, x, n_fft, int(n_fft * 0.25))
        spec = torch.stack([re, im], dim=1)
        n_freq = n_fft // 2 + 1
        maps, bands = [], []
        for bi, (b0, b1) in enumerate(d["bands"]):
            y = spec[..., int(b0 * n_freq):int(b1 * n_freq)]
            for ci, (_k, s, pad) in enumerate(MRD_SPECS):
                y = _lrelu(_conv2d(ops, p, f"{pre}/band_{bi}_conv_{ci}", y, s, pad))
                maps.append(y)
            bands.append(y)
        maps.append(_conv2d(ops, p, f"{pre}/conv_post", torch.cat(bands, dim=-1),
                            (1, 1), (1, 1)))
        out.append(maps)
    return out


# -- effects and augmentations ---------------------------------------------------------


def _linear_resize(x: torch.Tensor, new_len: int) -> torch.Tensor:
    old = x.shape[-1]
    pos = (torch.arange(new_len, dtype=torch.float32, device=x.device) + 0.5) \
        * (old / new_len) - 0.5
    pos = torch.clamp(pos, 0.0, old - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=old - 1)
    w = pos - lo
    return x[..., lo] * (1 - w) + x[..., hi] * w


def effect(ops: Ops, name: str, params: dict, audio: torch.Tensor,
           draws: Optional[dict], sr: int) -> torch.Tensor:
    """One attack of the training bank on ``[n, T]`` rows."""
    if name == "identity":
        return audio
    if name == "highpass_filter":
        return audio - dsp.lowpass(ops, audio, params["cutoff_freq"] / sr)
    if name == "lowpass_filter":
        return dsp.lowpass(ops, audio, params["cutoff_freq"] / sr)
    if name == "bandpass_filter":
        return (dsp.lowpass(ops, audio, params["cutoff_freq_high"] / sr)
                - dsp.lowpass(ops, audio, params["cutoff_freq_low"] / sr))
    if name == "speed":
        inter = int(round(sr / params["speed"]))
        return _linear_resize(dsp.resample(ops, audio, sr, inter), audio.shape[-1])
    if name == "resample":
        y = dsp.resample(ops, dsp.resample(ops, audio, sr, params["new_sample_rate"]),
                         params["new_sample_rate"], sr)
        t = audio.shape[-1]
        return y[..., :t] if y.shape[-1] >= t else F.pad(y, (0, t - y.shape[-1]))
    if name == "random_noise":
        return audio + params["noise_std"] * draws["noise"]
    raise ValueError(f"the reference has no attack {name!r}")


RANDOM_EFFECTS = ("random_noise",)


def attack(ops: Ops, bank: Sequence[Tuple[str, dict]], audio: torch.Tensor,
           effect_idx: np.ndarray, fx: Sequence[dict], sr: int) -> torch.Tensor:
    """Each row through the bank branch it chose. ``fx`` holds one dict of
    whole-batch draws per random branch, in bank order."""
    random_branches = [i for i, (n, _) in enumerate(bank) if n in RANDOM_EFFECTS]
    out = audio
    for e in np.unique(effect_idx):
        rows = torch.as_tensor(np.flatnonzero(effect_idx == e), device=audio.device)
        name, params = bank[e]
        draws = None
        if e in random_branches:
            draws = {k: v[rows] for k, v in fx[random_branches.index(e)].items()}
        out = out.index_put((rows,), effect(ops, name, params, audio[rows], draws, sr))
    return out


def localization(original, watermarked, scores, probs, offset, sr, window_s):
    """20% of the 0.1 s segments (lowest scores) reverted, zeroed or taken
    from another row's original; the presence mask is 0 on them."""
    b, t = watermarked.shape
    seg = int(window_s * sr)
    n_segs = -(-t // seg)
    n_mod = int(n_segs * 0.20)
    dev = watermarked.device
    ranks = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1, stable=True)
    modified_seg = ranks < n_mod
    of = torch.arange(t, device=dev) // seg
    modified = modified_seg[:, of]
    revert = (probs < 0.33)[:, of] & modified
    zero = ((probs >= 0.33) & (probs < 0.66))[:, of] & modified
    cross = (probs >= 0.66)[:, of] & modified
    donor = (torch.arange(b, device=dev)[:, None] + offset) % b
    donor_audio = original[donor[:, of], torch.arange(t, device=dev)[None, :]]
    aug = torch.where(revert, original, watermarked)
    aug = torch.where(zero, torch.zeros_like(aug), aug)
    aug = torch.where(cross, donor_audio, aug)
    upd = torch.where(zero, torch.zeros_like(original), original)
    upd = torch.where(cross, donor_audio, upd)
    return aug, (~modified).float(), upd


def sequence(xs, u: float, shift: int, perm: torch.Tensor, sr: int):
    """Reverse (u < 0.3), roll (< 0.7), shuffle 0.5 s segments (< 1.0)."""
    b, t = xs[0].shape
    seg = int(0.5 * sr)
    n = t // seg if t >= 2 * seg and t % seg == 0 else 1
    if u < 0.3:
        return [torch.flip(x, dims=(1,)) for x in xs]
    if u < 0.7:
        return [torch.roll(x, shift, dims=1) for x in xs]
    if u < 1.0 and n > 1:
        idx = perm.to(xs[0].device)
        return [x.reshape(b, n, seg)[:, idx, :].reshape(b, t) for x in xs]
    return list(xs)


# -- losses ---------------------------------------------------------------------------


def _abs(x: torch.Tensor) -> torch.Tensor:
    # |x| with derivative 1 at 0, as the model defines it
    return torch.where(x >= 0, x, -x)


def l1(x, y):
    return torch.mean(_abs(x - y))


def _mag(ops, x, n_fft):
    re, im = dsp.stft(ops, x, n_fft, n_fft // 4)
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-12))


def stft_loss(ops, x, y, windows):
    loss = x.new_zeros(())
    for w in windows:
        xm, ym = _mag(ops, x, w), _mag(ops, y, w)
        loss = loss + l1(torch.log10(torch.clamp(xm, min=1e-5) ** 2),
                         torch.log10(torch.clamp(ym, min=1e-5) ** 2)) + l1(xm, ym)
    return loss


def mel_loss(ops, x, y, sr, n_mels, windows, clamp_eps, pow_):
    loss = x.new_zeros(())
    for nm, w in zip(n_mels, windows):
        fb = torch.as_tensor(dsp.mel_filterbank(sr, w, nm).T.copy(), device=x.device)
        xm, ym = ops.matmul(_mag(ops, x, w), fb), ops.matmul(_mag(ops, y, w), fb)
        loss = loss + l1(torch.log10(torch.clamp(xm, min=clamp_eps) ** pow_),
                         torch.log10(torch.clamp(ym, min=clamp_eps) ** pow_))
    return loss


def bce(logits, target):
    return torch.mean(F.binary_cross_entropy_with_logits(logits, target, reduction="none"))


def disc_loss(ops, p, d, fake, real, alpha, gp_weight):
    d_fake = discriminator(ops, p, d, fake)
    d_real = discriminator(ops, p, d, real)
    loss = real.new_zeros(())
    for f, r in zip(d_fake, d_real):
        loss = loss + torch.mean(f[-1] ** 2) + torch.mean((1.0 - r[-1]) ** 2)
    interp = (alpha[:, None] * real + (1 - alpha[:, None]) * fake).detach()
    interp.requires_grad_(True)
    critic = sum(torch.sum(maps[-1]) for maps in discriminator(ops, p, d, interp))
    (g,) = torch.autograd.grad(critic, interp, create_graph=True)
    gnorm = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1) + 1e-12)
    return loss + gp_weight * torch.mean((gnorm - 1.0) ** 2)


# -- AdamW ---------------------------------------------------------------------------


def in_msg_path(name: str) -> bool:
    return any(part.startswith(("msg_", "film_")) for part in name.split("/"))


class AdamW:
    """AdamW with decoupled weight decay and ``lr * gamma ** t`` at update
    t (counted from 0)."""

    def __init__(self, names: Sequence[str], params: Params, optim: dict,
                 decay_exempt_msg: bool):
        self.names = list(names)
        self.lr, self.gamma = optim["lr"], optim["exp_gamma"]
        self.b1, self.b2 = optim["beta1"], optim["beta2"]
        self.wd = {n: 0.0 if decay_exempt_msg and in_msg_path(n) else WEIGHT_DECAY
                   for n in self.names}
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        lr = self.lr * self.gamma ** self.t
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n in self.names:
            g, p = grads[n], params[n]
            p.mul_(1 - lr * self.wd[n])
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[n].sqrt() / math.sqrt(c2) + ADAM_EPS
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def clip(grads: Params, names: Sequence[str], max_norm: float) -> torch.Tensor:
    """Scale ``grads[names]`` to a global L2 norm of at most ``max_norm``;
    returns the norm before."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(grads[n]) for n in names]))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for n in names:
        grads[n] = grads[n] * coef
    return norm


# -- the step ----------------------------------------------------------------------------


def check_train_config(cfg: dict) -> None:
    """Raise if the training configuration leaves what the reference
    implements: no warm-up controllers, no extra decoding terms, no
    sub-hop jitter, one learning rate, attacks of :func:`effect`."""
    lc, oc = cfg["loss"], cfg["optim"]
    off = [k for k in ("warmup_steps", "warmup_ber_gate", "lambda_dec_clean",
                       "lambda_dec_bits", "lambda_dec_lowband") if lc[k]]
    off += [k for k in ("generator_lr_mult", "detector_lr_mult") if oc[k] != 1.0]
    if cfg["sub_hop_jitter"]:
        off.append("sub_hop_jitter")
    if lc["mel_mag_weight"]:
        off.append("mel_mag_weight")
    if cfg["model"]["Discriminator"]["rates"]:
        off.append("Discriminator.rates")
    if off:
        raise ValueError(f"the reference does not implement {off}")


class TrainReference:
    """The four networks' weights and both optimizers; :meth:`step` is one
    training step. ``cfg`` is the configuration file's dict."""

    def __init__(self, cfg: dict, params: Params, ops: Optional[Ops] = None):
        for name in ("Generator", "Detector", "Locator"):
            nets.check_config(cfg["model"][name], name)
        check_train_config(cfg)
        self.cfg = cfg
        self.ops = ops or Ops()
        self.p = {k: v.detach().clone().float() for k, v in params.items()}
        self.disc_names = [n for n in self.p if n.startswith("discriminator/")]
        self.wm_names = [n for n in self.p if not n.startswith("discriminator/")]
        optim = cfg["optim"]
        exempt = optim.get("decay_exclude_msg_path", True)
        self.disc_opt = AdamW(self.disc_names, self.p, optim, False)
        self.wm_opt = AdamW(self.wm_names, self.p, optim, exempt)
        self.bank = [(e["name"], e["params"]) for e in cfg["train_effects"]]

    def _grads(self, loss, names) -> Params:
        gs = torch.autograd.grad(loss, [self.p[n] for n in names], allow_unused=True)
        return {n: torch.zeros_like(self.p[n]) if g is None else g
                for n, g in zip(names, gs)}

    def step(self, audio: torch.Tensor, msg: torch.Tensor, effect_idx: np.ndarray,
             draws: dict) -> Dict[str, object]:
        """One step; returns its losses and the gradients each optimizer
        stepped on (after the clip)."""
        cfg, ops = self.cfg, self.ops
        sm = cfg["model"]
        lc = cfg["loss"]
        sr = sm["Generator"]["sample_rate"]
        for n in self.p:
            self.p[n].requires_grad_(True)
        residual = nets.generator(ops, self.p, sm["Generator"], audio, msg)
        wm = residual + audio
        aug, mask, upd = localization(audio, wm, draws["loc_scores"], draws["loc_probs"],
                                      draws["loc_offset"], sr, cfg["window_duration"])
        aug, upd, mask = sequence([aug, upd, mask], draws["seq_u"], draws["seq_shift"],
                                  draws["seq_perm"], sr)
        fx_audio = attack(ops, self.bank, aug, effect_idx, draws["fx"], sr)
        det = nets.detector(ops, self.p, sm["Detector"], fx_audio)
        loc = nets.locator(ops, self.p, sm["Locator"], fx_audio)

        d = sm["Discriminator"]
        d_loss = disc_loss(ops, self.p, d, residual.detach(), audio, draws["gp_alpha"],
                           lc["gp_weight"])
        d_grads = self._grads(d_loss, self.disc_names)
        clip(d_grads, self.disc_names, MAX_GRAD_NORM)
        self.disc_opt.step(self.p, d_grads)

        for n in self.disc_names:
            self.p[n].requires_grad_(False)
        d_fake = discriminator(ops, self.p, d, wm)
        d_real = discriminator(ops, self.p, d, audio)
        adv = sum(torch.mean((1.0 - f[-1]) ** 2) for f in d_fake)
        feat = sum(torch.mean(_abs(fm - rm)) for f, r in zip(d_fake, d_real)
                   for fm, rm in zip(f[:-1], r[:-1]))
        logs = {
            "stft/loss": stft_loss(ops, wm, audio, lc["stft_window_lengths"]),
            "mel/loss": mel_loss(ops, wm, audio, sr, lc["mel_n_mels"],
                                 lc["mel_window_lengths"], lc["mel_clamp_eps"],
                                 lc["mel_pow"]),
            "waveform/loss": l1(wm, audio),
            "adv/gen_loss": adv,
            "adv/feat_loss": feat,
            "dec/loss": bce(det, msg[:, None, :] * mask[:, :, None]),
            "loc/loss": bce(loc, mask),
        }
        total = (lc["lambda_stft"] * logs["stft/loss"] + lc["lambda_mel"] * logs["mel/loss"]
                 + lc["lambda_waveform"] * logs["waveform/loss"]
                 + lc["lambda_adv_gen"] * logs["adv/gen_loss"]
                 + lc["lambda_dec"] * logs["dec/loss"] + lc["lambda_loc"] * logs["loc/loss"])
        wm_grads = self._grads(total, self.wm_names)
        gen = [n for n in self.wm_names if n.startswith("generator/")]
        clip(wm_grads, gen, MAX_GRAD_NORM)
        self.wm_opt.step(self.p, wm_grads)
        for n in self.p:
            self.p[n].requires_grad_(False)
        out = {k: float(v.detach()) for k, v in logs.items()}
        out["loss"] = float(total.detach())
        out["adv/disc_loss"] = float(d_loss.detach())
        out["grads"] = {**d_grads, **wm_grads}
        return out
