"""Container sniffing and native decoders for audio other than WAV (a copy
of ``waveverify_tpu/api/codecs.py``; numpy only).

- **Content sniffing**: decoding dispatches on magic bytes, never on the
  file extension (RIFF data inside a ``.ogg``-named file loads as WAV).
- **FLAC**: a pure numpy / Python decoder (constant, verbatim, fixed and
  LPC subframes, rice and rice2 residuals, every stereo decorrelation
  mode, UTF-8 frame headers, wasted bits).
- **Ogg, MP3, AAC, AIFF, MP4**: decoded through ``ffmpeg`` when it is on
  ``PATH``, else refused with an error naming the detected format.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Tuple

import numpy as np

logger = logging.getLogger(__name__)


def sniff_format(path) -> str:
    """Return one of 'wav', 'flac', 'ogg', 'mp3', 'aiff', 'mp4', 'unknown'
    from the file's leading magic bytes (extension is ignored)."""
    with open(path, "rb") as f:
        head = f.read(12)
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:4] == b"OggS":
        return "ogg"
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF
                              and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    if len(head) >= 12 and head[:4] == b"FORM" and head[8:12] in (b"AIFF",
                                                                  b"AIFC"):
        return "aiff"
    if len(head) >= 12 and head[4:8] == b"ftyp":
        return "mp4"
    return "unknown"


# ---------------------------------------------------------------------------
# FLAC decoder (format per the FLAC specification, RFC 9639)
# ---------------------------------------------------------------------------


class _Bits:
    """MSB-first bit reader over a bytes object."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos  # absolute bit position

    def read(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        p = self.pos
        self.pos = p + n
        start, end = p >> 3, (p + n + 7) >> 3
        chunk = int.from_bytes(self.data[start:end], "big")
        shift = (end << 3) - (p + n)
        return (chunk >> shift) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count zero bits up to the first one bit."""
        data, p = self.data, self.pos
        q = 0
        # fast path: scan whole bytes
        while True:
            byte = data[p >> 3]
            rem = 8 - (p & 7)
            window = byte & ((1 << rem) - 1)
            if window == 0:
                q += rem
                p += rem
                continue
            lead = rem - window.bit_length()
            q += lead
            p += lead + 1  # consume the terminating 1
            self.pos = p
            return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8_number(bits: _Bits) -> int:
    """FLAC's extended UTF-8 coded frame/sample number (up to 36 bits)."""
    b0 = bits.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n):
        val = (val << 6) | (bits.read(8) & 0x3F)
    return val


_BLOCKSIZE_TABLE = [0, 192, 576, 1152, 2304, 4608, -1, -2,
                   256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
_SAMPLE_SIZE_TABLE = [0, 8, 12, 0, 16, 20, 24, 32]
_SAMPLE_RATE_TABLE = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                      32000, 44100, 48000, 96000, -1, -2, -3, 0]

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(bits: _Bits, blocksize: int, pred_order: int) -> np.ndarray:
    method = bits.read(2)
    if method > 1:
        raise ValueError(f"reserved FLAC residual coding method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = bits.read(4)
    n_parts = 1 << part_order
    out = np.empty(blocksize - pred_order, np.int64)
    idx = 0
    part_len = blocksize >> part_order
    for part in range(n_parts):
        n = part_len - (pred_order if part == 0 else 0)
        param = bits.read(plen)
        if param == escape:
            raw_bits = bits.read(5)
            if raw_bits == 0:
                out[idx:idx + n] = 0
            else:
                for i in range(n):
                    out[idx + i] = bits.read_signed(raw_bits)
        else:
            read_unary = bits.read_unary
            read = bits.read
            for i in range(n):
                q = read_unary()
                r = read(param) if param else 0
                u = (q << param) | r
                out[idx + i] = (u >> 1) ^ -(u & 1)  # unzigzag
        idx += n
    return out


def _decode_subframe(bits: _Bits, blocksize: int, bps: int) -> np.ndarray:
    if bits.read(1):
        raise ValueError("invalid FLAC subframe padding bit")
    sf_type = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = 1 + bits.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        out = np.full(blocksize, bits.read_signed(bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.empty(blocksize, np.int64)
        for i in range(blocksize):
            out[i] = bits.read_signed(bps)
    elif 8 <= sf_type <= 12:  # FIXED, order = type - 8
        order = sf_type - 8
        out = np.empty(blocksize, np.int64)
        for i in range(order):
            out[i] = bits.read_signed(bps)
        res = _decode_residual(bits, blocksize, order)
        coeffs = _FIXED_COEFFS[order]
        o = out  # local alias
        if order == 0:
            o[:] = res
        else:
            r = res
            for i in range(order, blocksize):
                acc = 0
                for j, c in enumerate(coeffs):
                    acc += c * o[i - 1 - j]
                o[i] = acc + r[i - order]
    elif sf_type >= 32:  # LPC, order = type - 31
        order = sf_type - 31
        out = np.empty(blocksize, np.int64)
        for i in range(order):
            out[i] = bits.read_signed(bps)
        precision = bits.read(4) + 1
        if precision == 16:
            raise ValueError("invalid FLAC LPC precision escape")
        shift = bits.read_signed(5)
        coeffs = [bits.read_signed(precision) for _ in range(order)]
        res = _decode_residual(bits, blocksize, order)
        o = out
        r = res
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coeffs[j] * o[i - 1 - j]
            o[i] = (acc >> shift) + r[i - order]
    else:
        raise ValueError(f"reserved FLAC subframe type {sf_type}")

    if wasted:
        out <<= wasted
    return out


def decode_flac(path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file to (mono float32 in [-1, 1], sample_rate).

    From-scratch implementation of the FLAC bitstream (RFC 9639): metadata
    block walk, frame sync, all subframe types, rice/rice2 partitioned
    residuals, stereo decorrelation. Multi-channel input is mixed down to
    mono to match the WAV ingest path (train/data.py read_wav).
    """
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path} is not a FLAC file")
    pos = 4
    sample_rate = None
    n_channels = None
    bps = None
    total_samples = 0
    # metadata blocks
    while True:
        hdr = data[pos]
        block_type = hdr & 0x7F
        last = hdr & 0x80
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if block_type == 0:  # STREAMINFO
            b = _Bits(body)
            b.read(16); b.read(16)  # min/max blocksize
            b.read(24); b.read(24)  # min/max framesize
            sample_rate = b.read(20)
            n_channels = b.read(3) + 1
            bps = b.read(5) + 1
            total_samples = b.read(36)
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError(f"{path}: FLAC STREAMINFO block missing")

    collected = [[] for _ in range(n_channels)]
    bits = _Bits(data, pos << 3)
    total_bits = len(data) << 3
    n_done = 0
    while bits.pos + 32 <= total_bits and (total_samples == 0
                                           or n_done < total_samples):
        sync = bits.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"{path}: lost FLAC frame sync at bit {bits.pos}")
        bits.read(1)  # reserved
        bits.read(1)  # blocking strategy
        bs_code = bits.read(4)
        sr_code = bits.read(4)
        chan_code = bits.read(4)
        ss_code = bits.read(3)
        bits.read(1)  # reserved
        _read_utf8_number(bits)
        blocksize = _BLOCKSIZE_TABLE[bs_code]
        if blocksize == -1:
            blocksize = bits.read(8) + 1
        elif blocksize == -2:
            blocksize = bits.read(16) + 1
        sr = _SAMPLE_RATE_TABLE[sr_code]
        if sr == -1:
            bits.read(8)
        elif sr in (-2, -3):
            bits.read(16)
        frame_bps = _SAMPLE_SIZE_TABLE[ss_code] or bps
        bits.read(8)  # CRC-8 (not verified; malformed files fail sync instead)

        if chan_code < 8:
            n_ch = chan_code + 1
            sub = [_decode_subframe(bits, blocksize, frame_bps)
                   for _ in range(n_ch)]
        elif chan_code == 8:  # left/side
            left = _decode_subframe(bits, blocksize, frame_bps)
            side = _decode_subframe(bits, blocksize, frame_bps + 1)
            sub = [left, left - side]
        elif chan_code == 9:  # right/side
            side = _decode_subframe(bits, blocksize, frame_bps + 1)
            right = _decode_subframe(bits, blocksize, frame_bps)
            sub = [right + side, right]
        elif chan_code == 10:  # mid/side
            mid = _decode_subframe(bits, blocksize, frame_bps)
            side = _decode_subframe(bits, blocksize, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)
            sub = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"reserved FLAC channel assignment {chan_code}")
        bits.align()
        bits.read(16)  # CRC-16

        for c, s in enumerate(sub):
            collected[c].append(s)
        n_done += blocksize

    chans = [np.concatenate(parts) if parts else np.empty(0, np.int64)
             for parts in collected]
    if total_samples:
        chans = [c[:total_samples] for c in chans]
    scale = float(1 << (bps - 1))
    mono = np.mean(np.stack(chans, axis=0), axis=0) / scale
    return mono.astype(np.float32), int(sample_rate)


def decode_auto(path) -> Tuple[np.ndarray, int]:
    """Decode any supported container by content: (mono float32, sr).

    wav -> stdlib/native reader; flac -> native decoder; others -> ffmpeg
    when available, else a clear error naming the detected format.
    """
    from waveverify_torch.api.audio_io import read_wav

    fmt = sniff_format(path)
    if fmt == "wav":
        return read_wav(str(path))
    if fmt == "flac":
        return decode_flac(path)
    # compressed formats: ffmpeg if the image has it
    import shutil

    if shutil.which("ffmpeg") is not None:
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "quiet", "-i", str(path),
                 "-ac", "1", tmp.name],
                check=True,
            )
            return read_wav(tmp.name)
    raise RuntimeError(
        f"cannot decode {path}: detected format {fmt!r} and this image has "
        "no ffmpeg/soundfile (WAV and FLAC decode natively; note that "
        "extension is ignored — RIFF data inside a .ogg/.mp3-named file "
        "loads fine)"
    )
