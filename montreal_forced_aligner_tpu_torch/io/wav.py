"""Minimal dependency-free audio reading.

The reference decodes audio through libsndfile (``corpus/classes.py:26``,
``db_polars.py:1937-1996``). Baked-in images here have no libsndfile, so WAV
(PCM 8/16/24/32-bit and IEEE float) is parsed directly with numpy. Samples are
returned as float32 scaled to the int16 range (matching Kaldi's convention of
treating waveforms as 16-bit-scaled values, which the MFCC defaults assume).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class WaveData:
    samples: np.ndarray  # (num_samples,) float32, int16-scaled
    sample_rate: int
    num_channels: int
    duration: float


def _parse_wav(data: bytes, native: bool = False) -> Tuple[np.ndarray, int, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        chunk_size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, num_channels, sample_rate, _byte_rate, block_align, bits = fmt
    if audio_format == 0xFFFE and len(raw) > 0:  # WAVE_FORMAT_EXTENSIBLE
        # actual format is in the fmt extension; assume PCM/float by bits
        audio_format = 3 if bits == 32 and block_align == num_channels * 4 else 1
    if audio_format == 1:  # PCM
        if bits == 16:
            pcm16 = np.frombuffer(raw, dtype="<i2")
            samples = pcm16 if native else pcm16.astype(np.float32)
        elif bits == 8:
            samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float32) / 256.0  # scale to int16 range
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            samples = np.frombuffer(raw, dtype="<f4").astype(np.float32) * 32768.0
        elif bits == 64:
            samples = np.frombuffer(raw, dtype="<f8").astype(np.float32) * 32768.0
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    if num_channels > 1:
        samples = samples.reshape(-1, num_channels)
    return samples, sample_rate, num_channels


def probe_channels(path) -> int:
    """Channel count from the container header without decoding samples
    (the reference's ``get_wav_info``, ``corpus/classes.py:166-172``, used
    to map TextGrid tiers onto stereo channels)."""
    lower = str(path).lower()
    try:
        if lower.endswith(".flac"):
            with open(path, "rb") as f:
                head = f.read(64)
            if head[:4] != b"fLaC":
                return 1
            # STREAMINFO is the mandatory first metadata block (body at
            # offset 8); channels-1 occupies the 3 bits after the 20-bit
            # sample rate, i.e. bits 1-3 of body byte 12 (file byte 20)
            return ((head[20] >> 1) & 0x7) + 1
        if lower.endswith(".mp3") or lower.endswith(".opus"):
            return 1  # decoded downmixed; segment channel is always 0
        with open(path, "rb") as f:
            data = f.read(64 * 1024)
        if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            return 1
        pos = 12
        while pos + 8 <= len(data):
            chunk_id = data[pos : pos + 4]
            chunk_size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
            if chunk_id == b"fmt ":
                return struct.unpack(
                    "<HH", data[pos + 8 : pos + 12]
                )[1]
            pos += 8 + chunk_size + (chunk_size & 1)
    except Exception:
        pass
    return 1


def probe_wave(path) -> dict:
    """Container-level health check without full decode: returns
    {"sample_rate", "num_channels", "duration", "issue", "detail"} where
    ``issue`` is None for healthy files, or one of ``unreadable`` /
    ``truncated`` / ``empty``. Used by the corpus audit
    (reference wav triage, ``validation/corpus_validator.py:77``)."""
    lower = str(path).lower()
    out = {
        "sample_rate": None, "num_channels": None, "duration": None,
        "issue": None, "detail": "",
    }
    try:
        if lower.endswith(".flac"):
            with open(path, "rb") as f:
                head = f.read(64)
            if head[:4] != b"fLaC":
                out["issue"] = "unreadable"
                out["detail"] = "missing fLaC stream marker"
                return out
            # STREAMINFO: sample rate 20 bits at body offset 10,
            # channels-1 next 3 bits, bits/sample-1 next 5,
            # total samples 36 bits
            body = head[8:]
            rate = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
            channels = ((body[12] >> 1) & 0x7) + 1
            total = ((body[13] & 0x0F) << 32) | int.from_bytes(
                body[14:18], "big"
            )
            out["sample_rate"] = rate
            out["num_channels"] = channels
            out["duration"] = total / rate if rate else None
            if total == 0:
                out["issue"] = "empty"
                out["detail"] = "STREAMINFO reports zero samples"
            return out
        if lower.endswith(".mp3") or lower.endswith(".opus"):
            import os as _os

            size = _os.path.getsize(path)
            if size < 128:
                out["issue"] = "truncated"
                out["detail"] = f"only {size} bytes"
            return out
        import os as _os

        file_size = _os.path.getsize(path)
        fmt = None
        data_size = None
        data_offset = None
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                out["issue"] = "unreadable"
                out["detail"] = "not a RIFF/WAVE container"
                return out
            # seek chunk-by-chunk so arbitrarily large pre-data metadata
            # chunks (LIST/bext/cue) can't push fmt/data out of a fixed
            # read buffer and false-positive as unreadable
            pos = 12
            while pos + 8 <= file_size:
                f.seek(pos)
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                chunk_id = hdr[:4]
                chunk_size = struct.unpack("<I", hdr[4:8])[0]
                if chunk_id == b"fmt ":
                    fmt = struct.unpack("<HHIIHH", f.read(16))
                elif chunk_id == b"data":
                    data_size = chunk_size
                    data_offset = pos + 8
                    break
                pos += 8 + chunk_size + (chunk_size & 1)
        if fmt is None or data_size is None:
            out["issue"] = "unreadable"
            out["detail"] = "missing fmt/data chunk"
            return out
        _code, channels, rate, _bps, block_align, _bits = fmt
        out["sample_rate"] = rate
        out["num_channels"] = channels
        frames = data_size // max(block_align, 1)
        out["duration"] = frames / rate if rate else None
        available = file_size - data_offset
        if available + 8 < data_size:  # header promises more than exists
            out["issue"] = "truncated"
            out["detail"] = (
                f"data chunk declares {data_size} bytes but only "
                f"{available} are present (file cut short?)"
            )
            out["duration"] = (
                (available // max(block_align, 1)) / rate if rate else None
            )
        elif frames == 0:
            out["issue"] = "empty"
            out["detail"] = "zero-length data chunk"
        return out
    except (OSError, IndexError, struct.error, ValueError) as e:
        # files truncated inside their own headers land here
        out["issue"] = "unreadable"
        out["detail"] = str(e) or type(e).__name__
        return out


def read_wave(
    path,
    begin: float = 0.0,
    end: Optional[float] = None,
    channel: int = 0,
    native: bool = False,
) -> WaveData:
    """Read a (segment of a) WAV file; selects one channel. FLAC, MP3 and
    Opus raise ``NotImplementedError`` until their decoders are ported.

    With ``native=True``, sources whose samples are exactly representable as
    int16 (16-bit PCM WAV) are returned as int16 instead of
    float32. Values are identical either way (int16-scaled); the narrow
    dtype halves host memory traffic and host->device transfer on the
    alignment hot path, where waveforms are only padded and shipped.
    """
    lower = str(path).lower()
    native_i16 = False
    if lower.endswith((".flac", ".mp3", ".opus")):
        raise NotImplementedError(
            f"{path}: only WAV is decoded so far; FLAC/MP3/Opus decoding is "
            "ROADMAP.md Queue 1 item 16 (host extras)"
        )
    with open(path, "rb") as f:
        data = f.read()
    samples, sample_rate, num_channels = _parse_wav(data, native=native)
    native_i16 = samples.dtype == np.int16
    if num_channels > 1:
        samples = samples[:, channel]
    total = len(samples)
    start = max(0, int(round(begin * sample_rate)))
    stop = total if end is None else min(total, int(round(end * sample_rate)))
    seg = np.ascontiguousarray(
        samples[start:stop], dtype=np.int16 if native_i16 else np.float32
    )
    return WaveData(
        samples=seg,
        sample_rate=sample_rate,
        num_channels=num_channels,
        duration=total / sample_rate,
    )


def write_wave(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write int16-scaled float samples to a 16-bit PCM WAV.

    1-D input writes mono; (num_samples, num_channels) writes interleaved
    multichannel."""
    pcm = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    num_channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    data = pcm.tobytes()  # C order interleaves channels
    block_align = 2 * num_channels
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, 1, num_channels, sample_rate,
                sample_rate * block_align, block_align, 16,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
