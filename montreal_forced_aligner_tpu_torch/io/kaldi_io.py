"""Readers/writers for Kaldi's serialization format.

The reference framework stores acoustic models (``final.mdl``), decision trees
(``tree``) and occupancy vectors (``final.occs``) in Kaldi's binary/text object
format inside model archives (behavioral spec: reference ``models.py:360-586``
loads these via kalpy). This is a clean-room implementation of the container
format so pretrained MFA model archives can be loaded directly into arrays.

Format summary (public Kaldi on-disk format):

* A binary stream starts with the two bytes ``\\x00B``; otherwise text.
* *Tokens* are ASCII strings terminated by a single space.
* *Basic types* (int32/float/double) are written as one size byte followed by
  the raw little-endian value.
* *Integer vectors* are a size byte (of the element type), an int32 count,
  then ``count`` raw int32 values.
* *Vectors/Matrices* are the token ``FV``/``DV``/``FM``/``DM`` followed by
  int32 dims and raw data.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Tuple, Union

import numpy as np


class KaldiReadError(ValueError):
    pass


class KaldiBinaryReader:
    """Sequential reader over a Kaldi binary-mode stream (after ``\\x00B``)."""

    binary = True

    def __init__(self, stream: BinaryIO):
        self.stream = stream

    # -- low level -----------------------------------------------------------
    def read_bytes(self, n: int) -> bytes:
        data = self.stream.read(n)
        if len(data) != n:
            raise KaldiReadError(f"unexpected EOF: wanted {n} bytes, got {len(data)}")
        return data

    def peek_byte(self) -> bytes:
        pos = self.stream.tell()
        b = self.stream.read(1)
        self.stream.seek(pos)
        return b

    def read_token(self) -> str:
        chars = []
        while True:
            c = self.read_bytes(1)
            if c == b" ":
                break
            chars.append(c)
        return b"".join(chars).decode("utf-8")

    def expect_token(self, token: str) -> None:
        got = self.read_token()
        if got != token:
            raise KaldiReadError(f"expected token {token!r}, got {got!r}")

    def read_basic(self, fmt: str, size: int):
        # the size prefix byte is signed: +sizeof for signed types,
        # -sizeof (two's complement) for unsigned types
        size_byte = self.read_bytes(1)[0]
        if size_byte >= 128:
            size_byte = 256 - size_byte
        if size_byte != size:
            raise KaldiReadError(f"basic-type size mismatch: {size_byte} != {size}")
        return struct.unpack("<" + fmt, self.read_bytes(size))[0]

    def read_int32(self) -> int:
        return self.read_basic("i", 4)

    def read_uint32(self) -> int:
        return self.read_basic("I", 4)

    def read_float(self) -> float:
        return self.read_basic("f", 4)

    def read_double(self) -> float:
        return self.read_basic("d", 8)

    def read_bool(self) -> bool:
        c = self.read_bytes(1)
        if c == b"T":
            return True
        if c == b"F":
            return False
        raise KaldiReadError(f"bad bool byte {c!r}")

    def read_int32_vector(self) -> np.ndarray:
        size_byte = self.read_bytes(1)[0]
        if size_byte != 4:
            raise KaldiReadError(f"integer vector elem size {size_byte} != 4")
        count = struct.unpack("<i", self.read_bytes(4))[0]
        return np.frombuffer(self.read_bytes(4 * count), dtype="<i4").copy()

    # -- vectors / matrices --------------------------------------------------
    def read_vector(self) -> np.ndarray:
        token = self.read_token()
        if token == "FV":
            dtype, itemsize = "<f4", 4
        elif token == "DV":
            dtype, itemsize = "<f8", 8
        else:
            raise KaldiReadError(f"expected FV/DV, got {token!r}")
        dim = self.read_int32()
        return np.frombuffer(self.read_bytes(itemsize * dim), dtype=dtype).astype(
            np.float64 if dtype == "<f8" else np.float32
        )

    def read_matrix(self) -> np.ndarray:
        token = self.read_token()
        if token == "FM":
            dtype, itemsize = "<f4", 4
        elif token == "DM":
            dtype, itemsize = "<f8", 8
        else:
            raise KaldiReadError(f"expected FM/DM, got {token!r}")
        rows = self.read_int32()
        cols = self.read_int32()
        data = np.frombuffer(self.read_bytes(itemsize * rows * cols), dtype=dtype)
        return data.reshape(rows, cols).astype(
            np.float64 if dtype == "<f8" else np.float32
        )

    def read_packed_matrix(self) -> np.ndarray:
        """Kaldi SpMatrix/TpMatrix ("FP"/"DP"): lower-triangular
        row-major packing, expanded here to the full symmetric matrix."""
        token = self.read_token()
        if token == "FP":
            dtype, itemsize = "<f4", 4
        elif token == "DP":
            dtype, itemsize = "<f8", 8
        else:
            raise KaldiReadError(f"expected FP/DP, got {token!r}")
        size = self.read_int32()
        n_elems = size * (size + 1) // 2
        data = np.frombuffer(
            self.read_bytes(itemsize * n_elems), dtype=dtype
        ).astype(np.float64 if dtype == "<f8" else np.float32)
        out = np.zeros((size, size), dtype=data.dtype)
        idx = np.tril_indices(size)
        out[idx] = data
        out.T[idx] = data  # mirror to the upper triangle
        return out


class KaldiTextReader:
    """Sequential reader over a Kaldi text-mode object stream.

    Presents the same method surface as :class:`KaldiBinaryReader` so the
    model parsers work on either mode. Text mode differences (public Kaldi
    format): values are whitespace-separated ASCII; integer vectors and
    float vectors are bracketed ``[ ... ]``; matrices are bracketed with
    newline-delimited rows; booleans are the tokens ``T``/``F``.
    """

    binary = False

    def __init__(self, stream: BinaryIO):
        data = stream.read()
        if isinstance(data, (bytes, bytearray)):
            data = data.decode("utf-8")
        # tokenize, remembering which tokens start a new line (matrix rows)
        self._tokens: List[Tuple[str, bool]] = []
        for line in data.splitlines():
            first = True
            for tok in line.split():
                self._tokens.append((tok, first))
                first = False
        self._pos = 0

    def _next(self) -> Tuple[str, bool]:
        if self._pos >= len(self._tokens):
            raise KaldiReadError("unexpected EOF in text stream")
        tok = self._tokens[self._pos]
        self._pos += 1
        return tok

    def peek_token(self) -> str:
        if self._pos >= len(self._tokens):
            return ""
        return self._tokens[self._pos][0]

    def read_token(self) -> str:
        return self._next()[0]

    def expect_token(self, token: str) -> None:
        got = self.read_token()
        if got != token:
            raise KaldiReadError(f"expected token {token!r}, got {got!r}")

    def read_int32(self) -> int:
        return int(self.read_token())

    def read_uint32(self) -> int:
        return int(self.read_token())

    def read_float(self) -> float:
        return float(self.read_token())

    def read_double(self) -> float:
        return float(self.read_token())

    def read_bool(self) -> bool:
        tok = self.read_token()
        if tok == "T":
            return True
        if tok == "F":
            return False
        raise KaldiReadError(f"bad bool token {tok!r}")

    def _read_bracketed(self, cast):
        self.expect_token("[")
        out = []
        while True:
            tok = self.read_token()
            if tok == "]":
                break
            out.append(cast(tok))
        return out

    def read_int32_vector(self) -> np.ndarray:
        return np.array(self._read_bracketed(int), dtype=np.int32)

    def read_vector(self) -> np.ndarray:
        return np.array(self._read_bracketed(float), dtype=np.float32)

    def read_matrix(self) -> np.ndarray:
        self.expect_token("[")
        rows: List[List[float]] = []
        row: List[float] = []
        while True:
            tok, newline = self._next()
            if newline and row:
                rows.append(row)
                row = []
            if tok == "]":
                break
            row.append(float(tok))
        if row:
            rows.append(row)
        if not rows:
            return np.zeros((0, 0), dtype=np.float32)
        width = len(rows[0])
        if any(len(r) != width for r in rows):
            raise KaldiReadError("ragged text matrix")
        return np.array(rows, dtype=np.float32)


class KaldiBinaryWriter:
    """Sequential writer producing a Kaldi binary-mode stream."""

    def __init__(self, stream: BinaryIO, write_header: bool = True):
        self.stream = stream
        if write_header:
            stream.write(b"\x00B")

    def write_token(self, token: str) -> None:
        self.stream.write(token.encode("utf-8") + b" ")

    def write_int32(self, value: int) -> None:
        self.stream.write(b"\x04" + struct.pack("<i", value))

    def write_float(self, value: float) -> None:
        self.stream.write(b"\x04" + struct.pack("<f", value))

    def write_bool(self, value: bool) -> None:
        self.stream.write(b"T" if value else b"F")

    def write_int32_vector(self, values) -> None:
        arr = np.asarray(values, dtype="<i4")
        self.stream.write(b"\x04" + struct.pack("<i", arr.size))
        self.stream.write(arr.tobytes())

    def write_vector(self, vec: np.ndarray) -> None:
        vec = np.asarray(vec, dtype="<f4").reshape(-1)
        self.write_token("FV")
        self.write_int32(vec.size)
        self.stream.write(vec.tobytes())

    def write_matrix(self, mat: np.ndarray) -> None:
        mat = np.ascontiguousarray(np.asarray(mat, dtype="<f4"))
        if mat.ndim != 2:
            raise ValueError("matrix must be 2-D")
        self.write_token("FM")
        self.write_int32(mat.shape[0])
        self.write_int32(mat.shape[1])
        self.stream.write(mat.tobytes())

    # -- double-precision variants (Kaldi's ivector/PLDA objects store
    # double; genuine files carry DV/DM/DP tokens) ------------------------
    def write_double(self, value: float) -> None:
        self.stream.write(b"\x08" + struct.pack("<d", value))

    def write_vector_double(self, vec: np.ndarray) -> None:
        vec = np.asarray(vec, dtype="<f8").reshape(-1)
        self.write_token("DV")
        self.write_int32(vec.size)
        self.stream.write(vec.tobytes())

    def write_matrix_double(self, mat: np.ndarray) -> None:
        mat = np.ascontiguousarray(np.asarray(mat, dtype="<f8"))
        if mat.ndim != 2:
            raise ValueError("matrix must be 2-D")
        self.write_token("DM")
        self.write_int32(mat.shape[0])
        self.write_int32(mat.shape[1])
        self.stream.write(mat.tobytes())

    def write_packed_matrix_double(self, mat: np.ndarray) -> None:
        """Symmetric matrix in Kaldi packed ("DP") form."""
        mat = np.asarray(mat, dtype=np.float64)
        size = mat.shape[0]
        idx = np.tril_indices(size)
        self.write_token("DP")
        self.write_int32(size)
        self.stream.write(
            np.ascontiguousarray(mat[idx], dtype="<f8").tobytes()
        )


class KaldiTextWriter:
    """Sequential writer producing a Kaldi text-mode object stream.

    Same method surface as :class:`KaldiBinaryWriter`; vectors and integer
    vectors are bracketed, matrices bracketed with newline-separated rows
    (what ``gmm-copy --binary=false`` emits in public Kaldi).
    """

    binary = False

    def __init__(self, stream, write_header: bool = False):
        self.stream = stream

    def _w(self, text: str) -> None:
        try:
            self.stream.write(text)
        except TypeError:  # binary-mode stream
            self.stream.write(text.encode("utf-8"))

    def write_token(self, token: str) -> None:
        self._w(token + " ")

    def write_int32(self, value: int) -> None:
        self._w(f"{int(value)} ")

    def write_float(self, value: float) -> None:
        self._w(f"{float(value):.7g} ")

    def write_bool(self, value: bool) -> None:
        self._w("T " if value else "F ")

    def write_newline(self) -> None:
        self._w("\n")

    def write_int32_vector(self, values) -> None:
        vals = " ".join(str(int(v)) for v in np.asarray(values).reshape(-1))
        self._w(f"[ {vals} ]\n")

    def write_vector(self, vec: np.ndarray) -> None:
        vals = " ".join(f"{float(v):.7g}" for v in np.asarray(vec).reshape(-1))
        self._w(f" [ {vals} ]\n")

    def write_matrix(self, mat: np.ndarray) -> None:
        mat = np.asarray(mat)
        if mat.ndim != 2:
            raise ValueError("matrix must be 2-D")
        self._w(" [\n")
        for i, row in enumerate(mat):
            vals = " ".join(f"{float(v):.7g}" for v in row)
            self._w(f"  {vals}{' ]' if i == len(mat) - 1 else ''}\n")
        if mat.shape[0] == 0:
            self._w(" ]\n")


def open_kaldi_stream(path_or_bytes: Union[str, bytes]) -> Tuple[object, bool]:
    """Open a Kaldi object file; returns (reader, is_binary).

    Binary streams (``\\x00B`` header) get a :class:`KaldiBinaryReader`;
    everything else a :class:`KaldiTextReader` over the same token protocol.
    """
    import io as _io

    if isinstance(path_or_bytes, (bytes, bytearray)):
        stream: BinaryIO = _io.BytesIO(path_or_bytes)
    else:
        stream = open(path_or_bytes, "rb")
    head = stream.read(2)
    if head == b"\x00B":
        return KaldiBinaryReader(stream), True
    stream.seek(0)
    return KaldiTextReader(stream), False


def read_text_vector(text: str) -> np.ndarray:
    """Parse a Kaldi text-format vector like ``" [ 1 2 3 ]"`` (final.occs)."""
    toks = text.replace("[", " ").replace("]", " ").split()
    return np.array([float(t) for t in toks], dtype=np.float32)


def read_kaldi_object(path: str):
    """Convenience loader returning the first vector in a file."""
    reader, _binary = open_kaldi_stream(path)
    return reader.read_vector()
