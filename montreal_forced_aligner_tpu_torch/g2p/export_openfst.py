"""Export this framework's G2P models in the reference's archive format.

The reference's ``G2PModel`` (``models.py:930``) is a zip of ``model.fst``
(binary OpenFst), ``phones.txt``/``graphemes.txt`` symbol tables and
``meta.json``. This module compiles the trained graphone n-gram LM
(``g2p/trainer.G2PModel``) into a standard backoff n-gram transducer —
states are LM histories, symbol arcs carry -ln probabilities, epsilon arcs
carry backoff weights, final weights carry ``</s>`` probabilities — with
phonetisaurus-convention chunked labels (grapheme/phone chunks joined by
the sequence separator), and writes the reference bundle. Together with
``g2p/openfst_model.py`` (the import direction) G2P model interop is
two-way; the closed loop is tested by reloading an exported archive through
the import path and checking pronunciations agree with the graphone engine.
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.g2p.trainer import (
    EPS,
    G2PModel,
    parse_graphone,
)
from montreal_forced_aligner_tpu_torch.io.openfst import (
    SimpleFst,
    write_fst,
    write_symbol_table,
)
from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    BOS,
    EOS,
    LOG10 as LN10,
)

SEQUENCE_SEPARATOR = "|"


def _chunk_symbols(model: G2PModel):
    """Maps graphone vocabulary -> (ilabel, olabel) chunk symbol ids plus
    the two symbol tables (phonetisaurus convention: chunk parts joined by
    the sequence separator; empty sides are epsilon)."""
    gtable: Dict[str, int] = {"<eps>": 0}
    ptable: Dict[str, int] = {"<eps>": 0}
    pair_labels: Dict[str, Tuple[int, int]] = {}
    for (sym,) in model.lm.ngrams[1]:
        if sym in (BOS, EOS, "<unk>"):
            continue
        try:
            g, p = parse_graphone(sym)
        except ValueError:
            continue
        if g == (EPS,):
            il = 0
        else:
            gname = SEQUENCE_SEPARATOR.join(g)
            il = gtable.setdefault(gname, len(gtable))
        if p == (EPS,):
            ol = 0
        else:
            pname = SEQUENCE_SEPARATOR.join(p)
            ol = ptable.setdefault(pname, len(ptable))
        pair_labels[sym] = (il, ol)
    return pair_labels, gtable, ptable


def compile_ngram_fst(model: G2PModel) -> Tuple[SimpleFst, Dict, Dict]:
    """Standard backoff n-gram FST over the graphone LM (the layout
    OpenGrm's ``ngrammake`` produces: one state per history, symbol arcs at
    -ln p, epsilon backoff arcs at -ln backoff, ``</s>`` as final
    weights)."""
    lm = model.lm
    pair_labels, gtable, ptable = _chunk_symbols(model)

    # states: every proper history (prefix context). unigram state = ().
    histories = {()}
    for n in range(1, lm.order):
        for gram, (_lp, bo) in lm.ngrams[n].items():
            # a context state exists when the gram is a context of a longer
            # n-gram or carries a backoff weight; histories ending in </s>
            # are unreachable (EOS entries become final weights, never
            # arcs) and would be dead states
            if gram[-1] == EOS:
                continue
            histories.add(gram)
    state_of = {h: i for i, h in enumerate(sorted(histories, key=lambda t: (len(t), t)))}
    num_states = len(state_of)
    arcs: List[List[Tuple[int, int, float, int]]] = [[] for _ in range(num_states)]
    finals = np.full(num_states, np.inf, dtype=np.float32)

    def dest_state(hist: Tuple[str, ...], word: str) -> int:
        nxt = (hist + (word,))[-(lm.order - 1):] if lm.order > 1 else ()
        while nxt not in state_of:
            nxt = nxt[1:]
        return state_of[nxt]

    for n in range(1, lm.order + 1):
        for gram, (lp, _bo) in lm.ngrams[n].items():
            hist, word = gram[:-1], gram[-1]
            if hist not in state_of:
                continue
            s = state_of[hist]
            cost = -lp * LN10
            if word == EOS:
                finals[s] = min(finals[s], cost)
                continue
            if word == BOS:
                continue
            labels = pair_labels.get(word)
            if labels is None:
                continue
            il, ol = labels
            arcs[s].append((il, ol, float(cost), dest_state(hist, word)))
    # backoff arcs (epsilon:epsilon)
    for n in range(1, lm.order):
        for gram, (_lp, bo) in lm.ngrams[n].items():
            if gram not in state_of or len(gram) == 0:
                continue
            s = state_of[gram]
            shorter = gram[1:]
            while shorter not in state_of:
                shorter = shorter[1:]
            arcs[s].append((0, 0, float(-bo * LN10), state_of[shorter]))

    start_hist = (BOS,) if (BOS,) in state_of else ()
    fst = SimpleFst(
        start=state_of[start_hist], arcs=arcs, finals=finals,
        arc_type="standard",
    )
    return fst, gtable, ptable


def export_reference_g2p(model: G2PModel, path) -> Path:
    """Write the reference-format G2P zip (``model.fst`` + symbol tables +
    ``meta.json``). Returns the output path."""
    path = Path(path)
    fst, gtable, ptable = compile_ngram_fst(model)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_fst(fst, root / "model.fst")
        write_symbol_table(gtable, root / "graphemes.txt")
        write_symbol_table(ptable, root / "phones.txt")
        meta = {
            "architecture": "phonetisaurus",
            "sequence_separator": SEQUENCE_SEPARATOR,
            "grapheme_order": model.grapheme_order,
            "phone_order": model.phone_order,
            "version": model.meta.get("version", "0.1.0-tpu"),
            "unicode_decomposition": False,
            "graphemes": sorted({
                part
                for name in gtable
                if name != "<eps>"
                for part in name.split(SEQUENCE_SEPARATOR)
            }),
        }
        (root / "meta.json").write_text(
            json.dumps(meta, ensure_ascii=False)
        )
        import socket

        tmp_zip = path.with_name(
            f"{path.name}.tmp{socket.gethostname()}.{os.getpid()}"
        )
        with zipfile.ZipFile(tmp_zip, "w", zipfile.ZIP_DEFLATED) as zf:
            for p in sorted(root.iterdir()):
                zf.write(p, p.name)
        os.replace(tmp_zip, path)
    return path
