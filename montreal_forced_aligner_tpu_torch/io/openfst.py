"""OpenFst binary/text FST and symbol-table reading (host-side, no pynini).

Enough of the OpenFst 1.8 serialization format to load reference-trained
models — pynini G2P archives (``models.py:930``: ``model.fst`` +
``phones.txt``/``graphemes.txt``) write VectorFst<StdArc>/<LogArc>, the
format parsed here. ConstFst raises with a pointer to ``fstconvert``
(conversion is lossless and the vector form is what pynini emits anyway).

Layout (openfst ``fst.h`` ``FstHeader``, ``vector-fst.h``):

    int32  magic = 2125659606
    string fst_type      ("vector")          [int32 length + bytes]
    string arc_type      ("standard"/"log")
    int32  version (2)
    int32  flags   (1 = has isymbols, 2 = has osymbols)
    uint64 properties
    int64  start
    int64  numstates
    int64  numarcs (0 in practice for vector)
    [embedded SymbolTables when flagged]
    per state:
        float32 final_weight   (inf = non-final; tropical/log one = 0)
        int64   narcs
        narcs * { int32 ilabel, int32 olabel, float32 weight, int32 next }
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

FST_MAGIC = 2125659606
SYMBOL_TABLE_MAGIC = 2125658996


@dataclass
class SimpleFst:
    """In-memory FST: per-state arc lists (ilabel, olabel, weight, next)."""

    start: int
    arcs: List[List[Tuple[int, int, float, int]]]
    finals: np.ndarray  # (num_states,) float32, +inf = non-final
    arc_type: str = "standard"
    isymbols: Optional[Dict[str, int]] = None
    osymbols: Optional[Dict[str, int]] = None

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def i32(self) -> int:
        v = struct.unpack_from("<i", self.data, self.pos)[0]
        self.pos += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from("<q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.data, self.pos)[0]
        self.pos += 4
        return v

    def string(self) -> str:
        n = self.i32()
        s = self.data[self.pos : self.pos + n].decode("utf-8")
        self.pos += n
        return s


def _read_symbol_table_binary(r: _Reader) -> Dict[str, int]:
    """Embedded binary SymbolTable (openfst ``symbol-table.cc``)."""
    magic = r.i32()
    if magic != SYMBOL_TABLE_MAGIC:
        raise ValueError(f"bad SymbolTable magic {magic}")
    _name = r.string()
    _available_key = r.i64()
    size = r.i64()
    table: Dict[str, int] = {}
    for _ in range(size):
        sym = r.string()
        key = r.i64()
        table[sym] = key
    return table


def read_fst(path) -> SimpleFst:
    """Read a binary OpenFst file (VectorFst, standard or log arcs)."""
    data = Path(path).read_bytes()
    r = _Reader(data)
    magic = r.i32()
    if magic != FST_MAGIC:
        raise ValueError(
            f"{path}: not an OpenFst binary file (magic {magic})"
        )
    fst_type = r.string()
    arc_type = r.string()
    version = r.i32()
    flags = r.i32()
    _properties = r.u64()
    start = r.i64()
    num_states = r.i64()
    _num_arcs = r.i64()
    if fst_type != "vector":
        raise ValueError(
            f"{path}: fst type {fst_type!r} is not supported; convert with "
            "`fstconvert --fst_type=vector` (lossless) and retry"
        )
    if arc_type not in ("standard", "log"):
        raise ValueError(f"{path}: unsupported arc type {arc_type!r}")
    if version < 2:
        raise ValueError(f"{path}: VectorFst version {version} unsupported")
    isymbols = osymbols = None
    if flags & 0x1:
        isymbols = _read_symbol_table_binary(r)
    if flags & 0x2:
        osymbols = _read_symbol_table_binary(r)
    arcs: List[List[Tuple[int, int, float, int]]] = []
    finals = np.full(max(num_states, 0), np.inf, dtype=np.float32)
    for s in range(num_states):
        finals[s] = r.f32()
        narcs = r.i64()
        if narcs:
            block = np.frombuffer(
                r.data, dtype=np.uint8, count=16 * narcs, offset=r.pos
            ).reshape(narcs, 16)
            il = block[:, 0:4].copy().view("<i4").reshape(-1)
            ol = block[:, 4:8].copy().view("<i4").reshape(-1)
            w = block[:, 8:12].copy().view("<f4").reshape(-1)
            nx = block[:, 12:16].copy().view("<i4").reshape(-1)
            r.pos += 16 * narcs
            arcs.append(
                [
                    (int(il[k]), int(ol[k]), float(w[k]), int(nx[k]))
                    for k in range(narcs)
                ]
            )
        else:
            arcs.append([])
    if r.pos != len(data):
        raise ValueError(
            f"{path}: {len(data) - r.pos} trailing bytes after "
            f"{num_states} states — unsupported serialization variant"
        )
    return SimpleFst(
        start=int(start), arcs=arcs, finals=finals, arc_type=arc_type,
        isymbols=isymbols, osymbols=osymbols,
    )


def write_fst(fst: SimpleFst, path) -> None:
    """Write a binary VectorFst (inverse of :func:`read_fst`) readable by
    OpenFst/pynini — used to export models in the reference's format and to
    build test fixtures without pynini. When ``fst.isymbols``/``osymbols``
    are set they are embedded as binary SymbolTables (the self-describing
    form ``fstprint`` reads without external tables)."""
    out = bytearray()

    def s32(v):
        out.extend(struct.pack("<i", v))

    def s64(v):
        out.extend(struct.pack("<q", v))

    def sf(v):
        out.extend(struct.pack("<f", v))

    def sstr(s):
        b = s.encode("utf-8")
        s32(len(b))
        out.extend(b)

    def stable(name, table):
        s32(SYMBOL_TABLE_MAGIC)
        sstr(name)
        s64(max(table.values(), default=-1) + 1)  # available_key
        s64(len(table))
        for sym, key in sorted(table.items(), key=lambda kv: kv[1]):
            sstr(sym)
            s64(key)

    flags = (0x1 if fst.isymbols else 0) | (0x2 if fst.osymbols else 0)
    s32(FST_MAGIC)
    sstr("vector")
    sstr(fst.arc_type)
    s32(2)  # version
    s32(flags)
    out.extend(struct.pack("<Q", 3))  # properties: expanded|mutable
    s64(fst.start)
    s64(fst.num_states)
    s64(0)
    if fst.isymbols:
        stable("isymbols", fst.isymbols)
    if fst.osymbols:
        stable("osymbols", fst.osymbols)
    for s in range(fst.num_states):
        sf(float(fst.finals[s]))
        s64(len(fst.arcs[s]))
        for il, ol, w, nx in fst.arcs[s]:
            s32(il)
            s32(ol)
            sf(float(w))
            s32(nx)
    Path(path).write_bytes(bytes(out))


def write_symbol_table(table: Dict[str, int], path) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for sym, idx in sorted(table.items(), key=lambda kv: kv[1]):
            f.write(f"{sym}\t{idx}\n")


def read_symbol_table(path) -> Dict[str, int]:
    """Text symbol table (``symbol<TAB>id`` lines; OpenFst text format)."""
    table: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split()
            if len(parts) >= 2:
                table[parts[0]] = int(parts[1])
    return table


def shortest_paths(
    fst: SimpleFst,
    input_ids: "List",
    k: int = 1,
    max_eps_run: int = 32,
    ilabel_expansions: Optional[Dict[int, tuple]] = None,
) -> List[Tuple[List[int], float]]:
    """K cheapest accepting paths of ``fst`` composed with the linear
    acceptor over ``input_ids`` (tropical semiring). Returns
    [(output label sequence sans epsilons, total weight)], best first —
    the host-side equivalent of pynini's ``rewrite.rewrites`` /
    ``shortest_path`` used by the reference ``Rewriter``
    (``g2p/generator.py:153``).

    Composition is lazy over (fst state, input position); epsilon-input
    arcs advance only the FST state (bounded by ``max_eps_run`` consecutive
    epsilon steps to keep epsilon cycles finite). States may be re-expanded
    up to ``k`` times (standard k-shortest-paths relaxation).

    ``ilabel_expansions`` maps an arc input label to the input-token
    sequence it consumes (phonetisaurus-style chunked labels); tokens are
    compared by equality, so ``input_ids`` may be integer label ids or
    grapheme strings as long as the expansions use the same domain.
    Default: the label consumes exactly its own integer id.
    """
    import heapq

    G = len(input_ids)
    exp = ilabel_expansions
    pops: Dict[Tuple[int, int], int] = {}
    # heap entries: (cost, tiebreak, state, pos, eps_run, outputs)
    cnt = 0
    heap = [(0.0, cnt, fst.start, 0, 0, ())]
    results: List[Tuple[List[int], float]] = []
    seen_outputs = set()
    while heap and len(results) < k:
        cost, _t, s, pos, eps_run, outs = heapq.heappop(heap)
        key = (s, pos)
        pops[key] = pops.get(key, 0) + 1
        if pops[key] > k:
            continue
        if pos == G and np.isfinite(fst.finals[s]):
            out_seq = [o for o in outs if o != 0]
            sig = tuple(out_seq)
            if sig not in seen_outputs:
                seen_outputs.add(sig)
                results.append((out_seq, cost + float(fst.finals[s])))
        for il, ol, w, nx in fst.arcs[s]:
            if il == 0:
                if eps_run >= max_eps_run:
                    continue
                cnt += 1
                heapq.heappush(
                    heap, (cost + w, cnt, nx, pos, eps_run + 1, outs + (ol,))
                )
            else:
                toks = exp.get(il, ()) if exp is not None else (il,)
                n = len(toks)
                if (
                    n
                    and pos + n <= G
                    and tuple(input_ids[pos : pos + n]) == tuple(toks)
                ):
                    cnt += 1
                    heapq.heappush(
                        heap,
                        (cost + w, cnt, nx, pos + n, 0, outs + (ol,)),
                    )
    return results
