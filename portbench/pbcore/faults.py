"""Faults planted in the port underneath a run, to show that the comparison
deciding ``correct`` catches them (the CPU tests) and to read them at a
cell's own size on the card (``control.py --fault``). Each takes a
``pytest.MonkeyPatch`` (or anything with its ``setattr``) and undoes
nothing itself."""

from __future__ import annotations


def altered_answer(mp, net: str = "apply_detector", by: float = 0.1) -> None:
    """A network's output shifted where it is produced."""
    from waveverify_torch.models import WatermarkModels

    orig = getattr(WatermarkModels, net)
    mp.setattr(WatermarkModels, net, lambda self, *a: orig(self, *a) + by)


def altered_residual(mp) -> None:
    altered_answer(mp, "apply_generator", 1e-3)


def half_rows_left_out(mp) -> None:
    """``embed_batch`` watermarks the first half of the rows only."""
    from waveverify_torch import WaveVerify

    orig = WaveVerify.embed_batch

    def half(self, audio, bits):
        out = audio.copy()
        h = audio.shape[0] // 2
        out[:h] = orig(self, audio[:h], bits[:h])
        return out

    mp.setattr(WaveVerify, "embed_batch", half)


def mean_over_half(mp) -> None:
    """Detection averages over the first half of the samples only."""
    from waveverify_torch import WaveVerify

    orig = WaveVerify._detect_on
    mp.setattr(WaveVerify, "_detect_on",
               lambda self, models, device, audio, t:
               orig(self, models, device, audio, max(t // 2, 1)))


def state_unchanged(mp) -> None:
    """Optimizer steps that leave parameters and moments as they are."""
    import torch

    mp.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_batch(mp) -> None:
    """``train_step`` on the first half of the batch, its means over that
    half."""
    import waveverify_torch.train.step as st

    orig = st.train_step

    def half(state, cfg, bank, audio, msg, idx, draws, **kw):
        h = audio.shape[0] // 2
        return orig(state, cfg, bank, audio[:h], msg[:h], idx[:h], draws.rows(0, h), **kw)

    mp.setattr(st, "train_step", half)


def stale_after_warmup(mp, calls: int = 3) -> None:
    """From its ``calls + 1``-th call on, ``train_step`` runs on the batch
    of its ``calls``-th: stale inputs that only steps after set-up meet."""
    import waveverify_torch.train.step as st

    orig = st.train_step
    seen = []

    def stale(state, cfg, bank, audio, msg, idx, draws, **kw):
        seen.append((audio, msg))
        if len(seen) > calls:
            audio, msg = seen[calls - 1]
        return orig(state, cfg, bank, audio, msg, idx, draws, **kw)

    mp.setattr(st, "train_step", stale)


SERVE = {"answer_altered": altered_answer, "residual_altered": altered_residual,
         "half_batch": half_rows_left_out, "half_mean": mean_over_half}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "answer_altered": altered_answer, "stale_after_warmup": stale_after_warmup}
