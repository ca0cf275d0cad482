"""The port's native WAV ingest (``waveverify_torch.native``) against the JAX
package's ``_wavio``, both built here with ``g++`` from their sources:

- ``decode_wav`` bit for bit on every sample format the decoder takes, and
  the same error string on what it refuses;
- ``load_crop_batch`` bit for bit (crops, source rates, the first error)
  on a list with short, stereo, 24-bit, 22.05 kHz, FLAC and corrupt files;
- ``AudioFolderDataset(..., seed).batch(B)`` bit for bit against JAX's with
  its default ``use_native=True``, on a folder of 16-bit, 24-bit and stereo
  WAVs at 16 kHz, one 22.05 kHz WAV, one FLAC and one file shorter than
  the crop (the corrupt file is left out: JAX's Python fallback raises on
  it, which stops the batch);
- each native row a contiguous slice of the Python decode of its file
  within 2e-7 (the native mixdown sums channels in another order);
- six processes building at once leave one whole library, and without a
  compiler the dataset warns and takes the Python path, JAX's
  ``use_native=False`` crops."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.audio_files import SR, ingest_folder, riff, wav16
from waveverify_tpu.native import get_wavio as jget_wavio
from waveverify_tpu.train import data as jdata
from waveverify_torch import native
from waveverify_torch.api.audio_io import load_audio
from waveverify_torch.train import data

REPO = Path(__file__).resolve().parent.parent


FORMATS = {
    "pcm8": lambda: riff((np.random.RandomState(1).randint(0, 256, (900, 1))
                           ).astype(np.uint8), SR, 1, 8),
    "pcm16": lambda: wav16(1000, 2),
    "pcm16_stereo": lambda: wav16(1000, 3, channels=2),
    "pcm24": lambda: riff(np.random.RandomState(4).randint(
        -(1 << 23), 1 << 23, (800, 1)), SR, 1, 24),
    "pcm32_3ch": lambda: riff(np.random.RandomState(5).randint(
        -(1 << 31), (1 << 31) - 1, (700, 3)).astype("<i4"), SR, 1, 32),
    "float32": lambda: riff(np.random.RandomState(6).uniform(
        -1, 1, (600, 1)).astype("<f4"), SR, 3, 32),
    "float64_extensible": lambda: riff(np.random.RandomState(7).uniform(
        -1, 1, (500, 2)).astype("<f8"), 22050, 3, 64, extensible=True),
}
REFUSED = {
    "not_riff": b"OggS" + bytes(60),
    "no_data": riff(np.zeros((4, 1), "<i2"), SR, 1, 16)[:36] + bytes(8),
    "alaw": riff(np.zeros((40, 1), np.uint8), SR, 6, 8),
}


@pytest.fixture(scope="module")
def wavios():
    ours, ref = native.get_wavio(), jget_wavio()
    assert ours is not None and ref is not None, "g++ is needed here"
    return ours, ref


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_decode_wav_matches_jax(wavios, fmt):
    ours, ref = wavios
    blob = FORMATS[fmt]()
    x, sr = ours.decode_wav(blob)
    y, sr_j = ref.decode_wav(blob)
    assert sr == sr_j and x.dtype == y.dtype == np.float32 and len(x) > 0
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_decode_wav_refuses_as_jax(wavios, case):
    ours, ref = wavios
    with pytest.raises(ValueError) as t_err:
        ours.decode_wav(REFUSED[case])
    with pytest.raises(ValueError) as j_err:
        ref.decode_wav(REFUSED[case])
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("threads", [1, 0])
def test_load_crop_batch_matches_jax(wavios, tmp_path, threads):
    ours, ref = wavios
    root = ingest_folder(tmp_path / "f", corrupt=True)
    paths = [str(p) for p in sorted(root.iterdir())] * 2
    for seed in (0, 123456789):
        out, srs, err = ours.load_crop_batch(paths, 4000, seed, threads)
        r_out, r_srs, r_err = ref.load_crop_batch(paths, 4000, seed, threads)
        np.testing.assert_array_equal(out, r_out)
        np.testing.assert_array_equal(srs, r_srs)
        assert err == r_err and err
    assert list(srs[:7]) == [SR, SR, SR, 22050, 0, SR, 0]


def test_folder_batches_match_jax_native(tmp_path):
    root = ingest_folder(tmp_path / "f")
    ours = data.AudioFolderDataset([str(root)], 0.25, SR, seed=4)
    ref = jdata.AudioFolderDataset([str(root)], 0.25, SR, seed=4)
    assert ref.use_native
    assert [p.name for p in ours.files] == [p.name for p in ref.files]
    for n in (8, 5, 16):
        np.testing.assert_array_equal(ours.batch(n), ref.batch(n))
    assert ours.use_native and ref.use_native


def test_native_rows_are_slices_of_the_python_decode(wavios, tmp_path):
    ours, _ = wavios
    root = ingest_folder(tmp_path / "f")
    paths = [p for p in sorted(root.iterdir()) if p.suffix == ".wav"]
    out, srs, _ = ours.load_crop_batch([str(p) for p in paths], 1000, 7)
    for row, sr, p in zip(out, srs, paths):
        if sr != SR:
            continue
        x, _ = load_audio(p, SR)
        if len(x) <= 1000:
            np.testing.assert_allclose(row[:len(x)], x, atol=2e-7, rtol=0)
            assert not row[len(x):].any()
            continue
        hits = [s for s in range(len(x) - 1000 + 1)
                if np.abs(x[s:s + 1000] - row).max() <= 2e-7]
        assert hits, p.name


def test_concurrent_builds_leave_one_library(tmp_path):
    prog = ("import sys; from pathlib import Path; import waveverify_torch.native as n; "
            f"n._BUILD_DIR = Path({str(tmp_path)!r}); m = n.get_wavio(); "
            "x, sr = m.decode_wav(Path(sys.argv[1]).read_bytes()); print(len(x), sr)")
    wav = tmp_path / "one.wav"
    wav.write_bytes(wav16(300, 20))
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(wav)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert all(o.split() == ["300", str(SR)] for o, _ in outs)
    libs = sorted(tmp_path.glob("*.so"))
    assert [lib.name for lib in libs] == [native.library_path().name]


def test_without_a_compiler_the_python_path_gives_jax_crops(tmp_path, monkeypatch,
                                                            caplog):
    def no_compiler(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_wavio", None)
    monkeypatch.setattr(native, "_build_attempted", False)
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    root = ingest_folder(tmp_path / "f")
    ours = data.AudioFolderDataset([str(root)], 0.25, SR, seed=9)
    ref = jdata.AudioFolderDataset([str(root)], 0.25, SR, seed=9, use_native=False)
    with caplog.at_level("WARNING"):
        np.testing.assert_array_equal(ours.batch(6), ref.batch(6))
    assert not ours.use_native
    assert "native _wavio build failed" in caplog.text
    np.testing.assert_array_equal(ours.batch(3), ref.batch(3))
