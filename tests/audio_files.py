"""Audio files for the ingest checks, numpy only (it imports neither JAX nor
either package, so ``chip_smoke.py`` uses it on the card too): RIFF/WAVE
in every sample format the native decoder takes, a verbatim 16-bit FLAC,
and the mixed folder the ingest checks read."""

import struct
from pathlib import Path

import numpy as np

SR = 16000


def riff(samples: np.ndarray, sr: int, tag: int, bits: int,
         extensible: bool = False) -> bytes:
    """A RIFF/WAVE file of ``samples`` ``[T, channels]`` in their stored
    type (format ``tag`` 1 PCM or 3 float, or WAVE_FORMAT_EXTENSIBLE around
    it), with a LIST chunk before ``data``."""
    channels = samples.shape[1]
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels, sr,
                      sr * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) + bytes(14)
    if bits == 24:
        raw = samples.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        raw = samples.tobytes()
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
            + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def pcm(n: int, seed: int, amp: int = 12000) -> np.ndarray:
    """A 440 Hz tone plus noise as int16 values (int64)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    x = amp * np.sin(2 * np.pi * 440 * t) + rng.randint(-500, 500, n)
    return np.clip(x, -32768, 32767).astype(np.int64)


def wav16(n: int, seed: int, channels: int = 1, sr: int = SR) -> bytes:
    x = np.stack([pcm(n, seed + c) for c in range(channels)], 1)
    return riff(x.astype("<i2"), sr, 1, 16)


def wav24(n: int, seed: int, sr: int = SR) -> bytes:
    x = np.random.RandomState(seed).randint(-(1 << 22), 1 << 22, (n, 1))
    return riff(x, sr, 1, 24)


def _crc(data: bytes, poly: int, bits: int) -> int:
    top, mask, crc = 1 << (bits - 1), (1 << bits) - 1, 0
    for byte in data:
        crc ^= byte << (bits - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
    return crc


def flac16(x: np.ndarray, sr: int = SR, blocksize: int = 4096) -> bytes:
    """Mono 16-bit ``x`` (int values) as a FLAC stream of verbatim
    subframes."""
    def bits_to_bytes(bits):
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))

    def put(bits, value, n):
        bits.extend((value >> i) & 1 for i in range(n - 1, -1, -1))

    info = []
    for value, n in ((blocksize, 16), (blocksize, 16), (0, 24), (0, 24),
                     (sr, 20), (0, 3), (15, 5), (len(x), 36)):
        put(info, value, n)
    body = bits_to_bytes(info) + bytes(16)
    out = bytearray(b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body)
    for k, start in enumerate(range(0, len(x), blocksize)):
        seg = x[start:start + blocksize]
        hdr = []
        for value, n in ((0x3FFE, 14), (0, 2), (7, 4), (5 if sr == 16000 else 0, 4),
                         (0, 4), (4, 3), (0, 1), (k, 8), (len(seg) - 1, 16)):
            put(hdr, value, n)
        head = bits_to_bytes(hdr)
        head += bytes([_crc(head, 0x07, 8)])
        sub = [0, 0, 0, 0, 0, 0, 1, 0]  # verbatim, no wasted bits
        for v in seg:
            put(sub, int(v) & 0xFFFF, 16)
        while len(sub) % 8:
            sub.append(0)
        frame = head + bits_to_bytes(sub)
        out += frame + _crc(frame, 0x8005, 16).to_bytes(2, "big")
    return bytes(out)


def ingest_folder(root: Path, n: int = 9000, corrupt: bool = False) -> Path:
    """The ingest checks' folder: 16-bit, 24-bit and stereo WAVs at 16 kHz,
    one 22.05 kHz WAV, one FLAC and one WAV shorter than a 0.25 s crop;
    with ``corrupt`` a WAV the decoders refuse too."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "a16.wav").write_bytes(wav16(n, 10))
    (root / "b24.wav").write_bytes(wav24(n * 7 // 9, 11))
    (root / "c_stereo.wav").write_bytes(wav16(n * 8 // 9, 12, channels=2))
    (root / "d22k.wav").write_bytes(wav16(n, 14, sr=22050))
    (root / "e.flac").write_bytes(flac16(pcm(n * 2 // 3, 15)))
    (root / "f_short.wav").write_bytes(wav16(1500, 16))
    if corrupt:
        (root / "g_corrupt.wav").write_bytes(b"RIFF" + bytes(20))
    return root
