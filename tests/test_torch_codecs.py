"""The port's audio ingest against the JAX package's, on files made by
``tests/test_codecs.py``'s in-repo FLAC encoder: ``decode_flac``,
``decode_auto`` and ``sniff_format`` give equal samples and the same
answer; ``load_audio`` reads FLAC; ``AudioFolderDataset`` on a folder of
FLAC and WAV (one file at another rate, so resampling runs) gives the JAX
dataset's crops exactly; ``download_checkpoint`` refuses without a URL."""

import wave

import numpy as np
import pytest

from tests.test_codecs import _pcm, encode_flac
from waveverify_tpu.api import audio_io as jaudio_io
from waveverify_tpu.api import codecs as jcodecs
from waveverify_tpu.train import data as jdata
from waveverify_torch.api import audio_io, codecs
from waveverify_torch.train import data


def _write_wav(path, x, sr=16000, channels=1):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.asarray(x, np.int16).tobytes())


def _same_decode(path):
    a, sr_a = codecs.decode_auto(path)
    b, sr_b = jcodecs.decode_auto(path)
    assert sr_a == sr_b and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    if codecs.sniff_format(path) == "flac":
        c, sr_c = codecs.decode_flac(path)
        np.testing.assert_array_equal(c, a)
        assert sr_c == sr_a
    return a, sr_a


@pytest.mark.parametrize("mode", ["constant", "verbatim", "fixed0", "fixed1",
                                  "fixed2", "lpc"])
def test_flac_subframe_modes_match_jax(tmp_path, mode):
    n = 3000
    x = np.full(n, -1234, np.int64) if mode == "constant" else _pcm(n, 7)
    p = tmp_path / f"{mode}.flac"
    encode_flac(p, [x], modes=(mode,))
    audio, sr = _same_decode(p)
    assert sr == 16000
    np.testing.assert_array_equal(audio, (x / 32768.0).astype(np.float32))


@pytest.mark.parametrize("chan_mode", ["independent", "left_side",
                                       "right_side", "mid_side"])
def test_flac_stereo_decorrelation_matches_jax(tmp_path, chan_mode):
    left, right = _pcm(2500, 1), _pcm(2500, 2)
    p = tmp_path / f"{chan_mode}.flac"
    encode_flac(p, [left, right], modes=("verbatim", "fixed2", "lpc"),
                chan_mode=chan_mode)
    audio, _ = _same_decode(p)
    np.testing.assert_allclose(audio, (left + right) / 2.0 / 32768.0, atol=1e-7)


def test_flac_mixed_modes_and_blocksizes_match_jax(tmp_path):
    x = _pcm(7000, 3)
    for bs in (1024, 4096):
        p = tmp_path / f"mixed{bs}.flac"
        encode_flac(p, [x], blocksize=bs,
                    modes=("verbatim", "fixed1", "lpc", "fixed0", "fixed2"))
        _same_decode(p)


def test_sniff_format_matches_jax(tmp_path):
    _write_wav(tmp_path / "a.wav", _pcm(100))
    encode_flac(tmp_path / "b.flac", [_pcm(1024)])
    heads = {"c.ogg": b"OggS", "d.mp3": b"ID3\x03", "e.aiff": b"FORM\0\0\0\0AIFF",
             "f.m4a": b"\0\0\0\x20ftypM4A ", "g.bin": b"\x01\x02\x03\x04"}
    for name, head in heads.items():
        (tmp_path / name).write_bytes(head + b"\x00" * 32)
    for p in sorted(tmp_path.iterdir()):
        assert codecs.sniff_format(p) == jcodecs.sniff_format(p), p.name
    assert codecs.sniff_format(tmp_path / "b.flac") == "flac"


def test_misnamed_ogg_wav_and_stereo_wav_match_jax(tmp_path):
    p = tmp_path / "actually_wav.ogg"
    _write_wav(p, _pcm(1600, 4))
    audio, sr = _same_decode(p)
    assert sr == 16000 and audio.shape == (1600,)
    st = tmp_path / "stereo.wav"
    _write_wav(st, np.stack([_pcm(800, 5), _pcm(800, 6)], 1).ravel(), channels=2)
    _same_decode(st)


def test_load_audio_reads_flac_as_jax(tmp_path):
    x = _pcm(9000, 8)
    p = tmp_path / "clip.flac"
    encode_flac(p, [x], modes=("lpc", "fixed2"))
    a, sr = audio_io.load_audio(p)
    b, sr_j = jaudio_io.load_audio(p)
    assert sr == sr_j == 16000
    np.testing.assert_array_equal(a, b)
    a8, sr8 = audio_io.load_audio(p, 8000)
    b8, _ = jaudio_io.load_audio(p, 8000)
    assert sr8 == 8000 and a8.shape == (4500,)
    np.testing.assert_array_equal(a8, b8)


def test_folder_of_flac_and_wav_gives_jax_crops(tmp_path):
    encode_flac(tmp_path / "a.flac", [_pcm(12000, 9)], modes=("fixed2", "lpc"))
    encode_flac(tmp_path / "b.flac", [_pcm(3000, 10), _pcm(3000, 11)],
                modes=("verbatim",), chan_mode="mid_side")
    _write_wav(tmp_path / "c.wav", _pcm(9000, 12), sr=8000)
    _write_wav(tmp_path / "d.wav", _pcm(20000, 13))
    # the Python path in both (tests/test_torch_native.py holds the native
    # default to JAX's)
    ours = data.AudioFolderDataset([str(tmp_path)], 0.25, 16000, seed=4,
                                   use_native=False)
    ref = jdata.AudioFolderDataset([str(tmp_path)], 0.25, 16000, seed=4,
                                   use_native=False)
    assert [p.name for p in ours.files] == [p.name for p in ref.files]
    for n in (6, 5):
        np.testing.assert_array_equal(ours.batch(n), ref.batch(n))


def test_download_checkpoint_refuses_without_url():
    with pytest.raises(ValueError, match="no checkpoint URL"):
        audio_io.download_checkpoint()
