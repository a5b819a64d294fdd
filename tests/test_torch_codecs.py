"""The port's FLAC, MP3 and Opus decoding against the JAX package's, on the
CPU, with fixtures made here from a seed.

* FLAC from ``chip_smoke.py``'s writer (every subframe type, the four
  stereo channel assignments, a short last frame, 8-bit, a stream that
  does not declare its length) decodes to the samples written in the
  port's native decoder, the port's Python decoder and the JAX package's
  (its Python frame decoder), with the MD5 verified; the frame CRCs are
  FLAC's. A decode that comes up short and a failed build raise.
* MP3 made with ``libmp3lame`` and Ogg Opus made with ``libopus`` (and the
  Ogg page writer below) decode identically in both packages.
* ``probe_wave`` and ``probe_channels`` agree, and a mixed
  wav/flac/mp3/opus corpus loads the same utterances and audio in both
  packages' ``Corpus.load``.
"""

import ctypes
import ctypes.util
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

import montreal_forced_aligner_tpu.io.flac as JF
import montreal_forced_aligner_tpu_torch.io.flac as PF
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu.io.wav import probe_channels as j_probe_channels
from montreal_forced_aligner_tpu.io.wav import probe_wave as j_probe_wave
from montreal_forced_aligner_tpu.io.wav import read_wave as j_read_wave
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.io.wav import probe_channels, probe_wave
from montreal_forced_aligner_tpu_torch.io.wav import read_wave, write_wave
from montreal_forced_aligner_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SR = 16000


@pytest.fixture
def jax_python_flac(monkeypatch):
    """The JAX package's FLAC decode through its Python frame decoder (its
    native loader would build a library inside the JAX package)."""
    monkeypatch.setattr(JF, "_decode_frames_native", lambda *a: None)


def _signal(n, seed=0, silence=chip_smoke.FLAC_BLOCK, scale=800.0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    x = rng.randn(n) * scale + 2000 * np.sin(2 * np.pi * 440 * t + rng.rand())
    x[:silence] = 0
    return np.clip(np.round(x), -32768, 32767).astype(np.int64)


def _cases():
    x = _signal(12 * chip_smoke.FLAC_BLOCK + 1234)
    stereo = np.stack([x, np.clip(x // 2 + np.random.RandomState(1).randint(
        -64, 64, len(x)), -32768, 32767)], 1)
    return {
        "mono": (x, {}),
        "stereo": (stereo, {"seed": 1}),
        "undeclared_length": (x[:3 * chip_smoke.FLAC_BLOCK + 77],
                              {"declare_length": False}),
        "eight_bit": (np.clip(x // 256, -128, 127), {"bps": 8}),
        "small_blocks": (x[:5000], {"block": 1152, "verbatim_frame": 2}),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_flac_decodes_identically(case, tmp_path, monkeypatch, jax_python_flac):
    samples, opts = _cases()[case]
    kinds = []
    sub = chip_smoke._subframe_fields

    def record(x, bps, kind, **kw):
        kinds.append((kind, kw.get("order")))
        return sub(x, bps, kind, **kw)

    monkeypatch.setattr(chip_smoke, "_subframe_fields", record)
    path = tmp_path / f"{case}.flac"
    chip_smoke.write_flac_files([(path, samples, SR, opts)])
    want = samples.reshape(len(samples), -1)
    port = PF.decode_flac(path)
    jax = JF.decode_flac(path)
    assert port.md5_ok is True
    assert np.array_equal(port.samples, want)
    data = path.read_bytes()
    plain = PF._decode_frames_python(data, 42, len(want), want.shape[1],
                                     opts.get("bps", 16))
    assert np.array_equal(plain, want)
    if case == "undeclared_length":
        # the port decodes the frames to the end of the data; the JAX package
        # returns no samples (ROADMAP Queue 3)
        assert port.total_samples == 0 and len(jax.samples) == 0
    else:
        assert jax.md5_ok is True and np.array_equal(jax.samples, want)
        # the native loop is used whenever the length is declared
        monkeypatch.setattr(PF, "_decode_frames_python", None)
        assert np.array_equal(PF.decode_flac(path).samples, want)
    names = {k for k, _o in kinds}
    assert {"constant", "verbatim", "fixed", "lpc"} <= names or case in (
        "undeclared_length", "small_blocks")
    if case == "mono":
        assert {o for k, o in kinds if k == "fixed"} == {0, 1, 2, 3, 4}


def test_flac_frame_crcs(tmp_path):
    x = _signal(4 * chip_smoke.FLAC_BLOCK)
    _head, frames = chip_smoke.flac_encode(np.stack([x, x // 3], 1), SR)
    crcs = chip_smoke._crc16_many(frames)
    for frame, crc in zip(frames, crcs):
        assert crc == chip_smoke.flac_crc16(frame)
        # the header's CRC-8 covers the header up to itself
        end = 4 + 1 + (2 if frame[2] >> 4 == 7 else 0)
        assert frame[end] == chip_smoke.flac_crc8(frame[:end])
    # FLAC's check values ("123456789")
    assert chip_smoke.flac_crc8(b"123456789") == 0xF4
    assert chip_smoke.flac_crc16(b"123456789") == 0xFEE8
    # every stereo channel assignment occurs
    assert {f[3] >> 4 for f in frames} == {1, 8, 9, 10}


def test_flac_short_decode_and_failed_build_raise(tmp_path, monkeypatch):
    x = _signal(3 * chip_smoke.FLAC_BLOCK)
    path = tmp_path / "cut.flac"
    chip_smoke.write_flac_files([(path, x, SR, {})])
    data = path.read_bytes()
    path.write_bytes(data[: len(data) - 500])
    with pytest.raises(ValueError, match="STREAMINFO declares"):
        PF.decode_flac(path)
    bad = tmp_path / "flac_decode.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setitem(cuda_build.SOURCES, "flac_decode", cuda_build.Source(
        bad, "g++", cuda_build.SOURCES["flac_decode"].flags))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PF.decode_flac(tmp_path / "cut.flac")


def _lib(name):
    found = ctypes.util.find_library(name)
    if found is None:
        pytest.fail(f"lib{name} is not installed")
    return ctypes.CDLL(found)


def write_mp3(path, pcm, sr=SR):
    """Mono 16-bit PCM to a CBR MP3 through ``libmp3lame``."""
    lame = _lib("mp3lame")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lame.lame_init.restype = vp
    for fn in ("lame_set_in_samplerate", "lame_set_out_samplerate",
               "lame_set_num_channels", "lame_set_mode", "lame_set_brate",
               "lame_set_quality", "lame_set_bWriteVbrTag"):
        getattr(lame, fn).argtypes = [vp, ci]
    lame.lame_init_params.argtypes = [vp]
    lame.lame_encode_buffer.argtypes = [vp, vp, vp, ci, vp, ci]
    lame.lame_encode_flush.argtypes = [vp, vp, ci]
    lame.lame_close.argtypes = [vp]
    g = lame.lame_init()
    for fn, v in (("lame_set_in_samplerate", sr), ("lame_set_out_samplerate", sr),
                  ("lame_set_num_channels", 1), ("lame_set_mode", 3),
                  ("lame_set_brate", 64), ("lame_set_quality", 5),
                  ("lame_set_bWriteVbrTag", 0)):
        getattr(lame, fn)(g, v)
    assert lame.lame_init_params(g) == 0
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    buf = np.zeros(int(1.25 * len(pcm)) + 7200, dtype=np.uint8)
    n = lame.lame_encode_buffer(g, pcm.ctypes.data, pcm.ctypes.data, len(pcm),
                                buf.ctypes.data, len(buf))
    n += lame.lame_encode_flush(g, buf[n:].ctypes.data, len(buf) - n)
    lame.lame_close(g)
    Path(path).write_bytes(buf[:n].tobytes())


def _ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def _ogg_page(packet, granule, seq, flags, serial=7):
    lacing = [255] * (len(packet) // 255) + [len(packet) % 255]
    head = (b"OggS" + bytes([0, flags]) + struct.pack("<qIII", granule, serial,
                                                      seq, 0)
            + bytes([len(lacing)]) + bytes(lacing))
    page = head + packet
    return page[:22] + struct.pack("<I", _ogg_crc(page)) + page[26:]


def write_opus(path, pcm, sr=SR, frame_ms=20):
    """Mono 16-bit PCM to Ogg Opus: ``libopus`` encodes, and each packet
    goes on an Ogg page of its own after the OpusHead and OpusTags pages."""
    opus = _lib("opus")
    opus.opus_encoder_create.restype = ctypes.c_void_p
    opus.opus_encoder_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    opus.opus_encode.restype = ctypes.c_int
    opus.opus_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int]
    opus.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    err = ctypes.c_int(0)
    enc = opus.opus_encoder_create(sr, 1, 2049, ctypes.byref(err))
    assert enc and err.value == 0
    frame = sr * frame_ms // 1000
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    pcm = np.concatenate([pcm, np.zeros(-len(pcm) % frame, np.int16)])
    pre_skip = 312
    pages = [_ogg_page(b"OpusHead" + struct.pack("<BBHIhB", 1, 1, pre_skip, sr, 0, 0),
                       0, 0, 0x02),
             _ogg_page(b"OpusTags" + struct.pack("<I", 4) + b"test"
                       + struct.pack("<I", 0), 0, 1, 0)]
    out = np.zeros(4000, dtype=np.uint8)
    n_frames = len(pcm) // frame
    for i in range(n_frames):
        n = opus.opus_encode(enc, pcm[i * frame:].ctypes.data, frame,
                             out.ctypes.data, len(out))
        assert n > 0
        granule = pre_skip + (i + 1) * frame * (48000 // sr)
        pages.append(_ogg_page(out[:n].tobytes(), granule, i + 2,
                               0x04 if i == n_frames - 1 else 0))
    opus.opus_encoder_destroy(enc)
    Path(path).write_bytes(b"".join(pages))


def _mixed_corpus(root: Path):
    """A corpus of one file per format, each with a transcript."""
    x = _signal(SR * 2 + 321, seed=3, silence=0)
    spk = root / "spk"
    spk.mkdir(parents=True)
    write_wave(spk / "a.wav", x.astype(np.float32), SR)
    chip_smoke.write_flac_files([(spk / "b.flac", x, SR, {})])
    write_mp3(spk / "c.mp3", x)
    write_opus(spk / "d.opus", x)
    for stem in "abcd":
        (spk / f"{stem}.lab").write_text(f"word {stem}")
    return root


@pytest.mark.parametrize("ext", ["mp3", "opus"])
def test_mp3_and_opus_decode_identically(ext, tmp_path):
    x = _signal(SR + 777, seed=2, silence=0)
    path = tmp_path / f"a.{ext}"
    (write_mp3 if ext == "mp3" else write_opus)(path, x)
    got, want = read_wave(path), j_read_wave(path)
    assert got.sample_rate == want.sample_rate == (SR if ext == "mp3" else 48000)
    assert len(got.samples) > 0.9 * len(x) * want.sample_rate / SR
    assert np.array_equal(got.samples, want.samples)
    assert got.duration == want.duration


def test_probes_agree_with_jax(tmp_path, jax_python_flac):
    root = _mixed_corpus(tmp_path / "c")
    (root / "spk" / "bad.flac").write_bytes(b"not a flac" * 10)
    (root / "spk" / "bad.wav").write_bytes(b"RIFF" + b"\0" * 40)
    stereo = tmp_path / "s.flac"
    x = _signal(SR, silence=0)
    chip_smoke.write_flac_files([(stereo, np.stack([x, x // 2], 1), SR, {})])
    files = sorted((root / "spk").iterdir()) + [stereo]
    for path in files:
        assert probe_channels(path) == j_probe_channels(path), path
        if path.suffix != ".lab":
            assert probe_wave(path) == j_probe_wave(path), path
    assert probe_channels(stereo) == 2


def test_mixed_corpus_loads_like_jax(tmp_path, jax_python_flac):
    root = _mixed_corpus(tmp_path / "mixed")
    got, want = PCorpus.load(root), JCorpus.load(root)
    assert got.num_utterances == want.num_utterances == 4
    for u, v in zip(got.utterances, want.utterances):
        assert (u.file_name, u.speaker, u.text, u.channel) == (
            v.file_name, v.speaker, v.text, v.channel)
        a, b = got.load_audio(u), want.load_audio(v)
        assert a.sample_rate == b.sample_rate
        assert np.array_equal(a.samples, b.samples)
    # at the model's rate: Opus's 48 kHz resampled as the JAX package does
    for w, v in zip(got.load_audio_parallel(SR), want.load_audio_parallel(SR)):
        assert np.array_equal(w, v)
