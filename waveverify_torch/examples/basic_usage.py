"""Basic WaveVerify usage: embed -> detect -> verify -> locate (the port's
counterpart of ``examples/basic_usage.py``).

Run:  python -m waveverify_torch.examples.basic_usage [input.wav]
          [--checkpoint PATH] [--device cuda|cpu] [--outdir DIR]
With no input, a synthetic tone is generated so the example is
self-contained; with no checkpoint, the weights are random.
"""

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

from waveverify_torch import WatermarkID, WaveVerify
from waveverify_torch.api.audio_io import save_audio


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz, reference .pth or checkpoint directory "
                    "(random weights if unset)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--outdir", default="output")
    args = ap.parse_args(argv)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.input is None:
        print("no input given - generating a synthetic 3 s tone")
        t = np.arange(3 * 16000) / 16000
        tone = (0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.2 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)
        args.input = str(outdir / "input.wav")
        save_audio(tone, args.input)

    wv = WaveVerify(checkpoint_path=args.checkpoint, device=args.device)

    # 1. create a watermark identity
    wm = WatermarkID.for_creator("studio_abc")
    print(f"watermark: bits={wm.to_bits()} hex={wm.to_hex()}")

    # 2. embed
    out_path = outdir / "watermarked.wav"
    audio, sr, _ = wv.embed(args.input, wm, out_path)
    print(f"embedded -> {out_path} ({len(audio)} samples @ {sr} Hz)")

    # 3. detect
    detected, confidence = wv.detect(out_path)
    print(f"detected: bits={detected.to_bits()} confidence={confidence:.3f}")

    # 4. verify
    ok = wv.verify(out_path, wm)
    print(f"verify(expected={wm.to_hex()}): {'MATCH' if ok else 'MISMATCH'}"
          + ("" if args.checkpoint else "  (random weights - detection needs"
             " a trained checkpoint)"))

    # 5. locate
    mask = wv.locate(out_path)
    frac = float((mask > 0.5).mean())
    print(f"locate: {frac:.1%} of samples flagged as watermarked")

    # 6. false-positive check on clean audio
    clean_wm, clean_conf = wv.detect(args.input)
    print(f"clean audio detect: confidence={clean_conf:.3f} "
          f"bits={clean_wm.to_hex()}")


if __name__ == "__main__":
    main()
