"""FLAC decoder: a native C++ frame loop, and its plain Python version.

The reference decodes FLAC through libsndfile (``corpus/classes.py:26``),
which the package does not depend on. This is a clean-room decoder of the
FLAC format (constant/verbatim/fixed/LPC subframes, Rice-coded residuals,
stereo decorrelation); correctness is verified against the MD5 of the
unencoded samples stored in the STREAMINFO block. Frame decoding is
bit-serial and dominates corpus loading, so it runs in
``native/flac_decode.cc`` (ctypes, built by ``ops/cuda_build.py`` at first
use; a failed build raises). :func:`_decode_frames_python` is its plain
version with the same semantics, which the tests hold it against. The
native loop sizes its output from STREAMINFO, so only a stream that does
not declare its length goes to the Python decoder; a native decode that
comes up short raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.ops import cuda_build


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte_pos = pos
        self.bit_pos = 0

    def read_bit(self) -> int:
        b = (self.data[self.byte_pos] >> (7 - self.bit_pos)) & 1
        self.bit_pos += 1
        if self.bit_pos == 8:
            self.bit_pos = 0
            self.byte_pos += 1
        return b

    def read_uint(self, bits: int) -> int:
        out = 0
        while bits > 0:
            if self.bit_pos == 0 and bits >= 8:
                out = (out << 8) | self.data[self.byte_pos]
                self.byte_pos += 1
                bits -= 8
            else:
                take = min(bits, 8 - self.bit_pos)
                cur = self.data[self.byte_pos]
                val = (cur >> (8 - self.bit_pos - take)) & ((1 << take) - 1)
                out = (out << take) | val
                self.bit_pos += take
                if self.bit_pos == 8:
                    self.bit_pos = 0
                    self.byte_pos += 1
                bits -= take
        return out

    def read_int(self, bits: int) -> int:
        v = self.read_uint(bits)
        if v >= 1 << (bits - 1):
            v -= 1 << bits
        return v

    def read_unary(self) -> int:
        n = 0
        # fast path: skip whole zero bytes
        while True:
            if self.bit_pos == 0:
                while self.data[self.byte_pos] == 0:
                    n += 8
                    self.byte_pos += 1
            b = self.read_bit()
            if b:
                return n
            n += 1

    def align_to_byte(self) -> None:
        if self.bit_pos:
            self.bit_pos = 0
            self.byte_pos += 1

    def read_utf8_number(self) -> int:
        first = self.read_uint(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        value = first & (mask - 1)
        for _ in range(n_extra):
            value = (value << 6) | (self.read_uint(8) & 0x3F)
        return value


FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residuals(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read_uint(2)
    if method > 1:
        raise ValueError(f"bad residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read_uint(4)
    n_partitions = 1 << partition_order
    part_len = block_size >> partition_order
    out = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(n_partitions):
        count = part_len - (order if p == 0 else 0)
        param = br.read_uint(param_bits)
        if param == escape:
            bits = br.read_uint(5)
            for i in range(count):
                out[idx + i] = br.read_int(bits) if bits else 0
        else:
            for i in range(count):
                q = br.read_unary()
                r = br.read_uint(param) if param else 0
                v = (q << param) | r
                out[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += count
    return out


def _decode_subframe(
    br: _BitReader, block_size: int, bits_per_sample: int
) -> np.ndarray:
    if br.read_bit() != 0:
        raise ValueError("subframe sync error")
    sf_type = br.read_uint(6)
    wasted = 0
    if br.read_bit():
        wasted = 1 + br.read_unary()
    bps = bits_per_sample - wasted

    if sf_type == 0:  # constant
        v = br.read_int(bps)
        samples = np.full(block_size, v, dtype=np.int64)
    elif sf_type == 1:  # verbatim
        samples = np.array(
            [br.read_int(bps) for _ in range(block_size)], dtype=np.int64
        )
    elif 8 <= sf_type <= 12:  # fixed
        order = sf_type - 8
        warm = [br.read_int(bps) for _ in range(order)]
        resid = _decode_residuals(br, block_size, order)
        samples = np.empty(block_size, dtype=np.int64)
        samples[:order] = warm
        coeffs = FIXED_COEFFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * samples[i - 1 - j]
            samples[i] = resid[i - order] + pred
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        warm = [br.read_int(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        shift = br.read_int(5)
        coeffs = [br.read_int(precision) for _ in range(order)]
        resid = _decode_residuals(br, block_size, order)
        samples = np.empty(block_size, dtype=np.int64)
        samples[:order] = warm
        c_arr = np.array(coeffs, dtype=np.int64)
        for i in range(order, block_size):
            pred = int(np.dot(c_arr, samples[i - order : i][::-1])) >> shift
            samples[i] = resid[i - order] + pred
    else:
        raise ValueError(f"reserved subframe type {sf_type}")
    if wasted:
        samples = samples << wasted
    return samples


BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
SAMPLE_RATES = {
    0: None, 1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
SAMPLE_SIZES = {0: None, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


@dataclass
class FlacStream:
    sample_rate: int
    num_channels: int
    bits_per_sample: int
    total_samples: int
    samples: np.ndarray  # (total, channels) int32
    md5_ok: Optional[bool] = None


def decode_flac(path) -> FlacStream:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos = 4
    streaminfo = None
    while True:
        header = data[pos : pos + 4]
        last = header[0] >> 7
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:
            streaminfo = body
        pos += 4 + length
        if last:
            break
    if streaminfo is None:
        raise ValueError("missing STREAMINFO")
    si = _BitReader(streaminfo)
    si.read_uint(16)  # min block
    si.read_uint(16)  # max block
    si.read_uint(24)
    si.read_uint(24)
    sample_rate = si.read_uint(20)
    num_channels = si.read_uint(3) + 1
    bits_per_sample = si.read_uint(5) + 1
    total_samples = si.read_uint(36)
    md5 = streaminfo[18:34]

    if total_samples == 0:
        # STREAMINFO may leave the length undeclared (0). The native loop
        # sizes its output from it, so such a stream is decoded frame by
        # frame in Python, to the end of the data.
        out = _decode_frames_python(
            data, pos, total_samples, num_channels, bits_per_sample
        )
    else:
        out = _decode_frames_native(
            data, pos, total_samples, num_channels, bits_per_sample
        )

    # MD5 check over interleaved little-endian samples
    md5_ok = None
    if any(md5):
        interleaved = out.astype("<i8").reshape(-1)
        raw = bytearray()
        arr = interleaved.astype(np.int64)
        if bits_per_sample == 16:
            raw = arr.astype("<i2").tobytes()
        elif bits_per_sample == 8:
            raw = arr.astype("<i1").tobytes()
        elif bits_per_sample == 24:
            b32 = arr.astype("<i4").tobytes()
            raw = b"".join(
                b32[i : i + 3] for i in range(0, len(b32), 4)
            )
        elif bits_per_sample == 32:
            raw = arr.astype("<i4").tobytes()
        if raw:
            md5_ok = hashlib.md5(bytes(raw)).digest() == md5
    return FlacStream(
        sample_rate=sample_rate,
        num_channels=num_channels,
        bits_per_sample=bits_per_sample,
        total_samples=total_samples,
        samples=out,
        md5_ok=md5_ok,
    )


def _declare(lib) -> None:
    lib.flac_decode_frames.restype = ctypes.c_longlong
    lib.flac_decode_frames.argtypes = [
        ctypes.c_char_p,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]


def _decode_frames_native(
    data: bytes, pos: int, total_samples: int, num_channels: int,
    bits_per_sample: int,
) -> np.ndarray:
    """Frame decode through ``native/flac_decode.cc``; raises unless it
    returns the ``total_samples`` that STREAMINFO declares."""
    lib = cuda_build.load_library("flac_decode", _declare)
    out = np.empty(total_samples * num_channels, dtype=np.int32)
    n = lib.flac_decode_frames(
        data,
        len(data),
        pos,
        total_samples,
        num_channels,
        bits_per_sample,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if n != total_samples:
        raise ValueError(
            f"FLAC frame decode returned {n} of the {total_samples} samples "
            "that STREAMINFO declares (negative: a malformed frame)"
        )
    return out.reshape(total_samples, num_channels).astype(np.int64)


def _decode_frames_python(
    data: bytes, pos: int, total_samples: int, num_channels: int,
    bits_per_sample: int,
) -> np.ndarray:
    """Plain version of the native frame loop. ``total_samples == 0`` (a
    length STREAMINFO does not declare) reads frames to the end of ``data``."""
    frames = []
    written = 0
    br = _BitReader(data, pos)
    undeclared = total_samples == 0
    while (br.byte_pos < len(data)) if undeclared else (written < total_samples):
        br.align_to_byte()
        sync = br.read_uint(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at sample {written}")
        br.read_bit()  # reserved
        br.read_bit()  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        ss_code = br.read_uint(3)
        br.read_bit()  # reserved
        br.read_utf8_number()  # frame/sample number
        if bs_code == 6:
            block_size = br.read_uint(8) + 1
        elif bs_code == 7:
            block_size = br.read_uint(16) + 1
        else:
            block_size = BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        br.read_uint(8)  # header CRC

        if ch_code < 8:
            channels = ch_code + 1
            subframes = [
                _decode_subframe(br, block_size, bits_per_sample)
                for _ in range(channels)
            ]
            frame = np.stack(subframes, axis=1)
        else:
            # stereo decorrelation
            if ch_code == 8:  # left/side
                left = _decode_subframe(br, block_size, bits_per_sample)
                side = _decode_subframe(br, block_size, bits_per_sample + 1)
                right = left - side
                frame = np.stack([left, right], axis=1)
            elif ch_code == 9:  # right/side
                side = _decode_subframe(br, block_size, bits_per_sample + 1)
                right = _decode_subframe(br, block_size, bits_per_sample)
                left = right + side
                frame = np.stack([left, right], axis=1)
            elif ch_code == 10:  # mid/side
                mid = _decode_subframe(br, block_size, bits_per_sample)
                side = _decode_subframe(br, block_size, bits_per_sample + 1)
                left = (((mid << 1) | (side & 1)) + side) >> 1
                right = left - side
                frame = np.stack([left, right], axis=1)
            else:
                raise ValueError(f"bad channel code {ch_code}")
        br.align_to_byte()
        br.read_uint(16)  # frame CRC
        n = block_size if undeclared else min(block_size, total_samples - written)
        frames.append(frame[:n])
        written += n
    if not frames:
        return np.zeros((0, num_channels), dtype=np.int64)
    return np.concatenate(frames).astype(np.int64)
