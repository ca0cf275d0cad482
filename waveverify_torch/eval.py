"""Robustness sweep: ``python -m waveverify_torch.eval`` (counterpart of
``waveverify_tpu/eval.py``).

Embeds a random 16-bit message into each clip, reverts a contiguous span
of each clip to the clean signal (the ground-truth presence mask), attacks
the result with each effect (single or chained), then reports BER,
detection accuracy (TPR: the whole message decoded), FPR on clean audio,
and the locator's MIoU against the mask; a second, full-clip protocol
attacks the unspliced watermarked audio. The same rows, random bits,
splice mask, result keys and JSON layout as the JAX package's sweep.

Runs eagerly under ``torch.no_grad()`` on ``wv.device``; only the metrics
come back to the host, plus the clips STOI and the host codecs read.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# single effects (the JAX package's sweep rows)
EVAL_SINGLE = [
    ("identity", {}),
    ("resample", {"new_sample_rate": 8000}),
    ("resample", {"new_sample_rate": 32000}),
    ("speed", {"speed": 0.8}),
    ("highpass_filter", {"cutoff_freq": 3500}),
    ("lowpass_filter", {"cutoff_freq": 2000}),
    ("bandpass_filter", {"cutoff_freq_low": 300, "cutoff_freq_high": 4000}),
    ("random_noise", {"noise_std": 0.001}),
    # sub-hop circular shift: defeats a decode that is phase-locked to the
    # hop grid, which every other row leaves intact
    ("time_shift", {"shift": 161}),
]
# combined effects
EVAL_COMBINED = [
    [("highpass_filter", {"cutoff_freq": 3500}),
     ("random_noise", {"noise_std": 0.001})],
    [("lowpass_filter", {"cutoff_freq": 2000}), ("speed", {"speed": 0.8})],
    [("bandpass_filter", {"cutoff_freq_low": 300, "cutoff_freq_high": 4000}),
     ("resample", {"new_sample_rate": 32000})],
]
# external-codec rows, host round trips; each reports a `status`:
# "measured" when its encoder exists here, else "unavailable" and no numbers
EVAL_CODECS = [
    ("mp3", "mp3_lossy_compression", {"bitrate": "128k"}),
    ("aac", "aac_lossy_compression", {"bitrate": "128k"}),
    ("encodec", "encodec", {}),
]


def _effect_tag(chain: Sequence[Tuple[str, Dict]]) -> str:
    parts = []
    for name, params in chain:
        arg = ",".join(f"{v}" for v in params.values())
        parts.append(f"{name}({arg})" if arg else name)
    return " + ".join(parts)


@torch.no_grad()
def run_sweep(
    wv,
    audio: np.ndarray,
    seed: int = 0,
    effects: Optional[List[List[Tuple[str, Dict]]]] = None,
    splice_fraction: float = 0.2,
    include_codecs: bool = True,
    serve_dtype: str = "float32",
) -> Dict[str, Dict[str, float]]:
    """audio ``[B, T]`` clean clips -> ``{effect_tag: {ber, tpr, fpr, miou,
    confidence, ber_full, tpr_full, bit_acc_full}}`` plus ``_quality`` and
    the codec rows.

    ``serve_dtype="bfloat16"`` runs the network passes (generator, detector,
    locator) with bf16 activations while audio, effects and metrics stay
    f32. Run one dtype per :class:`WaveVerify`: each chain keeps its kernel
    weights for one dtype. ``random_noise`` draws from one
    ``torch.Generator`` on ``wv.device`` seeded with ``seed``."""
    from waveverify_torch.effects.effects import AudioEffects, codec_available
    from waveverify_torch.metrics import ber as ber_fn
    from waveverify_torch.metrics import miou as miou_fn
    from waveverify_torch.metrics import pesq as pesq_fn
    from waveverify_torch.metrics import sisnr as sisnr_fn
    from waveverify_torch.metrics import stoi as stoi_fn
    from waveverify_torch.serve import resolve_dtype

    if effects is None:
        effects = [[e] for e in EVAL_SINGLE] + [list(c) for c in EVAL_COMBINED]

    models, dev, sr = wv.models, wv.device, wv.sample_rate
    act = resolve_dtype(serve_dtype)

    def det(x):
        return models.apply_detector(x.to(act)).float()

    def loc(x):
        return models.apply_locator(x.to(act)).float()

    b, t = audio.shape
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (b, 16)).astype(np.float32)

    # ground-truth presence mask: splice a clean span back in
    mask = np.ones((b, t), np.float32)
    span = int(t * splice_fraction)
    starts = rng.randint(0, max(t - span, 1), b)
    for i, s in enumerate(starts):
        mask[i, s : s + span] = 0.0

    clean = torch.tensor(np.asarray(audio, np.float32), device=dev)
    bits_d = torch.tensor(bits, device=dev)
    mask_d = torch.tensor(mask, device=dev)
    residual = models.apply_generator(clean.to(act), bits_d.to(act)).float()
    wm = residual + clean
    spliced = torch.where(mask_d > 0.5, wm, clean)

    def apply_chain(x, m, chain, gen):
        for name, params in chain:
            x, m2 = getattr(AudioEffects, name)(x, m, gen, sample_rate=sr, **params)
            m = m if m2 is None else m2
        return x, m

    results: Dict[str, Dict[str, float]] = {}
    # imperceptibility of the watermarked audio against the clean input
    wm_np = wm.cpu().numpy()
    pesq_mean = float(np.mean([pesq_fn(wm_np[i], audio[i], sr) for i in range(b)]))
    results["_quality"] = {
        "sisnr_db": float(sisnr_fn(wm, clean)),
        "stoi": float(np.mean([stoi_fn(wm_np[i], audio[i], sr) for i in range(b)])),
        # None (JSON null) when the pesq library is absent
        "pesq": None if np.isnan(pesq_mean) else pesq_mean,
    }
    logger.info("%-40s sisnr=%.2f dB stoi=%.4f pesq=%s", "quality(wm vs clean)",
                results["_quality"]["sisnr_db"], results["_quality"]["stoi"],
                results["_quality"]["pesq"])

    gen = torch.Generator(device=dev).manual_seed(seed)
    for chain in effects:
        tag = _effect_tag(chain)
        x, m = apply_chain(spliced, mask_d, chain, gen)
        det_l, loc_l = det(x), loc(x)
        bit_probs = torch.mean(torch.sigmoid(det_l), dim=1).cpu().numpy()
        sample_ber = ber_fn(det_l, bits_d, m, per_sample=True)
        sample_miou = miou_fn(torch.sigmoid(loc_l), m, per_sample=True)
        conf = torch.mean(torch.sigmoid(det_l), dim=(1, 2))
        # clean-audio confidence for FPR
        probs_clean = torch.mean(torch.sigmoid(det(clean)), dim=1).cpu().numpy()
        # full-clip protocol: watermark everywhere, no spliced-clean span
        xf, mf = apply_chain(wm, torch.ones_like(mask_d), chain, gen)
        det_full = det(xf)
        bit_probs_full = torch.mean(torch.sigmoid(det_full), dim=1).cpu().numpy()
        sample_ber_full = ber_fn(det_full, bits_d, mf, per_sample=True)

        decoded = (bit_probs > 0.5).astype(np.float32)
        exact = (decoded == bits).all(axis=1)  # full-message recovery
        decoded_full = (bit_probs_full > 0.5).astype(np.float32)
        exact_full = (decoded_full == bits).all(axis=1)
        # clean-audio false positives: clean decodes to the embedded message
        fp = ((probs_clean > 0.5).astype(np.float32) == bits).all(axis=1)
        results[tag] = {
            "ber": float(sample_ber.mean()),
            "tpr": float(np.mean(exact)),
            "fpr": float(np.mean(fp)),
            "miou": float(sample_miou.mean()),
            "confidence": float(conf.mean()),
            "ber_full": float(sample_ber_full.mean()),
            "tpr_full": float(np.mean(exact_full)),
            # per-bit accuracy over the batch (full-clip protocol)
            "bit_acc_full": [round(float(a), 4) for a in
                             (decoded_full == bits).mean(axis=0)],
        }
        acc = np.asarray(results[tag]["bit_acc_full"])
        logger.info("%-40s ber=%.4f tpr=%.3f fpr=%.3f miou=%.4f "
                    "ber_full=%.4f tpr_full=%.3f bit_acc[min=%.2f "
                    "n<=0.25=%d n>=0.75=%d] %s",
                    tag, *[results[tag][k] for k in
                           ("ber", "tpr", "fpr", "miou", "ber_full", "tpr_full")],
                    float(acc.min()), int((acc <= 0.25).sum()),
                    int((acc >= 0.75).sum()),
                    "[" + ",".join(f"{a:.2f}" for a in acc) + "]")

    if include_codecs:
        for codec, fn_name, params in EVAL_CODECS:
            tag = f"{codec}({params.get('bitrate', '')})".replace("()", "")
            if not codec_available(codec):
                results[tag] = {
                    "status": f"unavailable: no {codec} encoder/weights in this image",
                }
                logger.info("%-40s %s", tag, results[tag]["status"])
                continue
            attacked, _ = getattr(AudioEffects, fn_name)(
                spliced, mask_d, None, sample_rate=sr, **params)
            det_l, loc_l = det(attacked), loc(attacked)
            bit_probs = torch.mean(torch.sigmoid(det_l), dim=1).cpu().numpy()
            decoded = (bit_probs > 0.5).astype(np.float32)
            results[tag] = {
                "status": "measured",
                "ber": float(ber_fn(det_l, bits_d, mask_d, per_sample=True).mean()),
                "tpr": float(np.mean((decoded == bits).all(axis=1))),
                "miou": float(miou_fn(torch.sigmoid(loc_l), mask_d,
                                      per_sample=True).mean()),
            }
            logger.info("%-40s ber=%.4f tpr=%.3f miou=%.4f", tag,
                        results[tag]["ber"], results[tag]["tpr"],
                        results[tag]["miou"])
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="waveverify_torch robustness sweep")
    ap.add_argument("--checkpoint", required=True,
                    help="a .npz written by save_weights_npz (its __config__ "
                    "snapshot sets the architecture)")
    ap.add_argument("--audio-folders", nargs="*", default=[],
                    help="folders of eval WAVs (synthetic clips if empty)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--conv-precision", default="highest",
                    choices=("highest", "high", "default"),
                    help="f32 convolutions and matmuls outside the chain "
                    "kernel: 'highest' turns TF32 off for cuDNN and cuBLAS; "
                    "'high' and 'default' allow TF32 for both")
    ap.add_argument("--serve-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="activation dtype of the network passes; sweep both "
                    "and diff for bfloat16's effect on BER")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from waveverify_torch.api.core import WaveVerify
    from waveverify_torch.serve import set_conv_precision
    from waveverify_torch.train.data import AudioFolderDataset, SyntheticAudioDataset

    wv = WaveVerify(args.checkpoint, device=args.device,
                    serve_dtype=args.serve_dtype)
    set_conv_precision(args.conv_precision)
    if args.audio_folders:
        ds = AudioFolderDataset(args.audio_folders, args.duration,
                                wv.sample_rate, args.seed)
    else:
        logger.warning("no audio folders: using synthetic clips")
        ds = SyntheticAudioDataset(args.duration, wv.sample_rate, args.seed)
    audio = ds.batch(args.batch)

    results = run_sweep(wv, audio, seed=args.seed, serve_dtype=args.serve_dtype)

    q = results.get("_quality", {})
    if q:
        pesq_s = "n/a (pesq lib absent)" if q["pesq"] is None else f"{q['pesq']:.3f}"
        print(f"\nquality (watermarked vs clean): SI-SNR {q['sisnr_db']:.2f} dB  "
              f"STOI {q['stoi']:.4f}  PESQ {pesq_s}")
    print(f"\n{'effect':<42} {'BER':>7} {'TPR':>6} {'FPR':>6} {'MIoU':>7}")
    for tag, r in results.items():
        if tag == "_quality":
            continue
        if "ber" not in r:  # codec row without a usable encoder
            print(f"{tag:<42} {r.get('status', 'unavailable')}")
            continue
        print(f"{tag:<42} {r['ber']:>7.4f} {r.get('tpr', float('nan')):>6.3f} "
              f"{r.get('fpr', float('nan')):>6.3f} {r['miou']:>7.4f}")
    if args.json_out:
        payload = {"_meta": {"checkpoint": args.checkpoint,
                             "batch": args.batch,
                             "duration": args.duration,
                             "seed": args.seed,
                             "conv_precision": args.conv_precision,
                             "serve_dtype": args.serve_dtype,
                             "real_audio": bool(args.audio_folders),
                             "audio_folders": list(args.audio_folders)}}
        payload.update(results)
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"\nwrote {args.json_out}")


if __name__ == "__main__":
    main()
