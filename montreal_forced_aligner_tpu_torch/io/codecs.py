"""MP3 and Opus decoding via system codec libraries (ctypes).

The reference reads mp3/opus through libsndfile/librosa
(``corpus/classes.py:26``; CommonVoice corpora ship mp3, MLS ships opus).
This module binds the system ``libmpg123`` for MP3 and ``libopus`` for Opus
(with a pure-Python Ogg page demuxer, so libopusfile is not needed).
No package dependencies; where a library is missing, decoding that format
raises.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import List, Optional, Tuple

import numpy as np

_mpg123 = None
_opus = None


def _load(names) -> Optional[ctypes.CDLL]:
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


# ---------------------------------------------------------------------------
# MP3 (libmpg123)
# ---------------------------------------------------------------------------

MPG123_OK = 0
MPG123_DONE = -12
MPG123_NEW_FORMAT = -11
MPG123_ENC_SIGNED_16 = 0x10 | 0x80  # MPG123_ENC_16 | MPG123_ENC_SIGNED


def _mpg123_lib():
    global _mpg123
    if _mpg123 is None:
        lib = _load(["libmpg123.so.0", "libmpg123.so"])
        if lib is None:
            raise RuntimeError("libmpg123 not available for MP3 decoding")
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _mpg123 = lib
    return _mpg123


def decode_mp3(path) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file to (samples (N, C) int16, sample_rate)."""
    lib = _mpg123_lib()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        if lib.mpg123_open(h, str(path).encode()) != MPG123_OK:
            raise RuntimeError(f"cannot open mp3 {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        lib.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        )
        # lock the output format to native-rate signed 16-bit
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, MPG123_ENC_SIGNED_16)
        chunks: List[bytes] = []
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if ret == MPG123_DONE:
                break
            if ret not in (MPG123_OK, MPG123_NEW_FORMAT):
                break
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
        C = max(channels.value, 1)
        pcm = pcm[: (len(pcm) // C) * C].reshape(-1, C)
        return pcm, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# ---------------------------------------------------------------------------
# Opus (pure-Python Ogg demuxer + libopus)
# ---------------------------------------------------------------------------


def _ogg_packets(data: bytes) -> List[bytes]:
    """Demux an Ogg stream into packets (single logical stream assumed;
    Ogg framing per RFC 3533: 27-byte page header + segment lacing table,
    packets continue across pages when a lacing value is 255)."""
    packets: List[bytes] = []
    partial = b""
    pos = 0
    n = len(data)
    while pos + 27 <= n:
        if data[pos : pos + 4] != b"OggS":
            nxt = data.find(b"OggS", pos + 1)
            if nxt < 0:
                break
            pos = nxt
            continue
        n_segs = data[pos + 26]
        lacing = data[pos + 27 : pos + 27 + n_segs]
        body = pos + 27 + n_segs
        for lv in lacing:
            partial += data[body : body + lv]
            body += lv
            if lv < 255:
                packets.append(partial)
                partial = b""
        pos = body
    if partial:
        packets.append(partial)
    return packets


def _opus_lib():
    global _opus
    if _opus is None:
        lib = _load(["libopus.so.0", "libopus.so"])
        if lib is None:
            raise RuntimeError("libopus not available for Opus decoding")
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.opus_decode.restype = ctypes.c_int
        lib.opus_decode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        _opus = lib
    return _opus


OPUS_SR = 48000
_MAX_FRAME = 5760  # 120 ms at 48 kHz


def decode_opus(path) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Opus file to (samples (N, C) int16, 48000)."""
    with open(path, "rb") as f:
        data = f.read()
    packets = _ogg_packets(data)
    if not packets or not packets[0].startswith(b"OpusHead"):
        raise ValueError(f"not an Ogg Opus file: {path}")
    head = packets[0]
    channels = head[9]
    pre_skip = struct.unpack("<H", head[10:12])[0]
    # output gain (Q7.8 dB) per RFC 7845 §5.1
    gain_q8 = struct.unpack("<h", head[16:18])[0]
    gain = 10.0 ** (gain_q8 / (20.0 * 256.0))
    audio_packets = packets[1:]
    if audio_packets and audio_packets[0].startswith(b"OpusTags"):
        audio_packets = audio_packets[1:]

    lib = _opus_lib()
    err = ctypes.c_int(0)
    dec = lib.opus_decoder_create(OPUS_SR, channels, ctypes.byref(err))
    if not dec or err.value != 0:
        raise RuntimeError(f"opus_decoder_create failed ({err.value})")
    try:
        out = np.empty((_MAX_FRAME, channels), dtype=np.int16)
        pieces = []
        for pkt in audio_packets:
            ns = lib.opus_decode(
                dec,
                pkt,
                len(pkt),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                _MAX_FRAME,
                0,
            )
            if ns > 0:
                pieces.append(out[:ns].copy())
        pcm = (
            np.concatenate(pieces, axis=0)
            if pieces
            else np.zeros((0, channels), np.int16)
        )
    finally:
        lib.opus_decoder_destroy(dec)
    pcm = pcm[pre_skip:]
    if gain_q8:
        pcm = np.clip(
            pcm.astype(np.float32) * gain, -32768, 32767
        ).astype(np.int16)
    return pcm, OPUS_SR
