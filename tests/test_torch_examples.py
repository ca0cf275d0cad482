"""The port's examples on the CPU with no checkpoint (random init), the web
example's request handler called directly (no port is opened), and the
training CLI with an effects YAML whose ``train_effects``,
``eval_effects`` and ``effect_param_grid`` list all 20 on-device effects."""

import io
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.catalog import CATALOG20, catalog_yaml
from tests.test_torch_trainer import TINY_YAML
from waveverify_torch import WaveVerify
from waveverify_torch.effects.effects_config import load_effects_config
from waveverify_torch.examples import basic_usage, watermark_strategies
from waveverify_torch.examples import web_api_integration as web
from waveverify_torch.train.__main__ import main as train_main

torch.set_num_threads(2)


def _wav_bytes(seconds=0.3, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(x.tobytes())
    return buf.getvalue()


def test_basic_usage_runs_on_the_cpu(tmp_path, capsys):
    clip = tmp_path / "in.wav"
    clip.write_bytes(_wav_bytes())
    basic_usage.main([str(clip), "--device", "cpu", "--outdir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    for word in ("embedded ->", "detected:", "verify(", "locate:", "clean audio"):
        assert word in out
    assert (tmp_path / "out" / "watermarked.wav").exists()


def test_basic_usage_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        basic_usage.main(["--outdir", "/nonexistent-never-written"])


def test_watermark_strategies_runs(capsys):
    watermark_strategies.main()
    out = capsys.readouterr().out
    assert "for_creator('studio_abc')" in out and "2 unique of 3" in out


@pytest.fixture(scope="module")
def server():
    web.wv = WaveVerify(None, device="cpu")
    yield web
    web.wv = None


def test_web_handler_serves_every_endpoint(server):
    code, ctype, body = server.handle("GET", "/health")
    assert code == 200 and json.loads(body)["framework"] == "waveverify_torch"
    assert server.handle("GET", "/nope")[0] == 404
    code, ctype, wav = server.handle("POST", "/watermark/embed?watermark=0xBEEF",
                                     _wav_bytes())
    assert code == 200 and ctype == "audio/wav" and wav[:4] == b"RIFF"
    code, _, body = server.handle("POST", "/watermark/detect", wav)
    det = json.loads(body)
    assert code == 200 and len(det["bits"]) == 16 and 0 <= det["confidence"] <= 1
    code, _, body = server.handle("POST", "/watermark/locate", wav)
    loc = json.loads(body)
    assert code == 200 and 0 <= loc["presence_ratio"] <= 1 and loc["mask_downsampled"]
    code, _, body = server.handle("POST", "/watermark/detect", b"not audio")
    assert code == 500 and "error" in json.loads(body)
    assert server.handle("POST", "/elsewhere", b"")[0] == 404


def test_training_cli_takes_the_whole_catalog(tmp_path):
    fx = tmp_path / "fx.yml"
    fx.write_text(catalog_yaml())
    parsed = load_effects_config(str(fx))
    assert parsed.source == str(fx) and list(parsed.train_effects) == CATALOG20
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(TINY_YAML)
    train_main(["--config", str(cfg), "--device", "cpu", "--ckpt-dir",
                str(tmp_path / "run"), "--log-every", "1", "--max-steps", "2",
                "--effects-config", str(fx), "--no-samples"])
    lines = [json.loads(s) for s in
             Path(tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    val = [r for r in lines if "val/loss" in r]
    assert val and all(np.isfinite(v) for r in lines for v in r.values())
    # one validation row per effect; a repeated name is tagged <name>_<i>
    tags = [k[len("val/ber/"):] for k in val[0] if k.startswith("val/ber/")]
    assert len(tags) == len(CATALOG20)
    names = {n for n, _ in CATALOG20}
    assert all(t in names or t.rsplit("_", 1)[0] in names for t in tags), tags
