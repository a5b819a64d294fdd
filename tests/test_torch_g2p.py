"""The port's G2P against the JAX package's, on the CPU.

Both packages run the same host Python, so models, generated
pronunciations and log10 scores are compared with ``==``:

* ``G2PTrainer`` (Phonetisaurus-style) and ``PairNgramTrainer`` (the
  ``train_g2p`` default) on ``chip_smoke.py``'s spelled dictionary and on
  ``tests/test_g2p.py``'s ``make_pairs`` recipe: the same n-gram tables,
  pronunciations and scores; ``evaluate_g2p`` agrees.
* Archives written by either package's ``G2PModel.save`` and by
  ``export_reference_g2p`` load in the other and generate the same; a
  port-written reference-format archive parses with the JAX package's
  ``OpenFstG2PModel``.
* The ``train_g2p`` (plain, ``--phonetisaurus``, ``--evaluate``,
  ``--reference_format``), ``g2p`` (a word list and a corpus directory,
  ``--dictionary_path``, ``--export_scores``, ``--sorted``,
  ``--num_pronunciations``, ``--config_path``) and ``validate_dictionary``
  commands print the same lines and write the same files as the JAX CLI's.
"""

import sys
from pathlib import Path

import pytest
from click.testing import CliRunner

import montreal_forced_aligner_tpu.cli as JCLI
from montreal_forced_aligner_tpu.g2p.export_openfst import (
    export_reference_g2p as j_export,
)
from montreal_forced_aligner_tpu.g2p.generator import G2PGenerator as JGen
from montreal_forced_aligner_tpu.g2p.generator import evaluate_g2p as j_evaluate
from montreal_forced_aligner_tpu.g2p.openfst_model import OpenFstG2PModel as JOpenFst
from montreal_forced_aligner_tpu.g2p.pair_ngram import PairNgramTrainer as JPair
from montreal_forced_aligner_tpu.g2p.trainer import G2PModel as JModel
from montreal_forced_aligner_tpu.g2p.trainer import G2PTrainer as JTrainer
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.g2p.export_openfst import (
    export_reference_g2p as p_export,
)
from montreal_forced_aligner_tpu_torch.g2p.generator import G2PGenerator as PGen
from montreal_forced_aligner_tpu_torch.g2p.generator import evaluate_g2p as p_evaluate
from montreal_forced_aligner_tpu_torch.g2p.openfst_model import (
    OpenFstG2PModel as POpenFst,
)
from montreal_forced_aligner_tpu_torch.g2p.pair_ngram import PairNgramTrainer as PPair
from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel as PModel
from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PTrainer as PTrainer
from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid

from test_g2p import make_pairs

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

PHONES = [f"p{i:02d}" for i in range(24)]


@pytest.fixture(scope="module")
def spelled(tmp_path_factory):
    """``chip_smoke.py``'s spelled dictionary over 24 phones (20 spelled by
    one letter, 4 by two): 90 words, 30 of them held out."""
    tmp = tmp_path_factory.mktemp("spelled")
    dict_path, words, held = chip_smoke.build_spelled_lexicon(
        tmp, PHONES, num_words=90, held_out=30, seed=3)
    train = [(w, words[w]) for w in sorted(words) if w not in set(held)]
    return tmp, dict_path, train, [(w, words[w]) for w in held]


def _same_generation(jmodel, pmodel, words, n=3):
    jgen, pgen = JGen(jmodel), PGen(pmodel)
    out = []
    for w in words:
        want = jgen.generate(w, n)
        assert pgen.generate(w, n) == want, w
        out.append(want)
    return out


ENGINES = {
    "phonetisaurus": (lambda: JTrainer(order=4, num_alignment_iterations=4),
                      lambda: PTrainer(order=4, num_alignment_iterations=4)),
    "pair_ngram": (lambda: JPair(order=4, num_random_starts=2),
                   lambda: PPair(order=4, num_random_starts=2)),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("data", ["spelled", "make_pairs"])
def test_trainers_match_jax(engine, data, spelled):
    if data == "spelled":
        _tmp, _d, train, test = spelled
    else:
        pairs = make_pairs(n=90, seed=1)
        train, test = pairs[:-20], pairs[-20:]
    make_j, make_p = ENGINES[engine]
    jmodel = make_j().train_from_pairs(train)
    pmodel = make_p().train_from_pairs(train)
    assert pmodel.lm.ngrams == jmodel.lm.ngrams
    assert pmodel.meta == jmodel.meta
    assert (pmodel.grapheme_order, pmodel.phone_order) == (
        jmodel.grapheme_order, jmodel.phone_order)
    prons = _same_generation(jmodel, pmodel, [w for w, _p in test + train[:10]])
    assert all(prons)
    got = p_evaluate(PGen(pmodel), test, num_pronunciations=2)
    assert got == j_evaluate(JGen(jmodel), test, num_pronunciations=2)
    if data == "spelled":
        # a spelling determines its phones
        assert got["word_accuracy"] >= 0.9


def test_archives_cross_packages(spelled, tmp_path):
    _tmp, _d, train, test = spelled
    words = [w for w, _p in test]
    model = PTrainer(order=4, num_alignment_iterations=4).train_from_pairs(train)
    jmodel = JTrainer(order=4, num_alignment_iterations=4).train_from_pairs(train)
    model.save(tmp_path / "port.zip")
    jmodel.save(tmp_path / "jax.zip")
    # each package reads the other's archive and generates what the writer's
    # own package generates from it
    for name in ("port.zip", "jax.zip"):
        _same_generation(JModel.load(tmp_path / name), PModel.load(tmp_path / name),
                         words)
    assert PModel.load(tmp_path / "jax.zip").lm.ngrams == JModel.load(
        tmp_path / "port.zip").lm.ngrams
    # reference-format archives, both ways, and the port's through the JAX
    # package's OpenFst reader
    p_export(model, tmp_path / "port_ref.zip")
    j_export(jmodel, tmp_path / "jax_ref.zip")
    for name in ("port_ref.zip", "jax_ref.zip"):
        j_loaded, p_loaded = JModel.load(tmp_path / name), PModel.load(tmp_path / name)
        assert isinstance(j_loaded, JOpenFst) and isinstance(p_loaded, POpenFst)
        for w in words:
            assert p_loaded.generate(w, 2) == j_loaded.generate(w, 2)
    # the round trip: the exported archive generates the graphone engine's
    # best pronunciation on training words
    loaded = PModel.load(tmp_path / "port_ref.zip")
    gen = PGen(model)
    for w, _p in train[:10]:
        assert loaded.generate(w, 1)[0][0] == gen.generate(w, 1)[0][0]


def _jax_cli(command, args):
    out = CliRunner().invoke(command, [str(a) for a in args],
                             catch_exceptions=False)
    assert out.exit_code == 0, out.output
    return out.output


def _both(capsys, name, command, args, rename=()):
    """Port and JAX CLI outputs of one command, with each package's own
    paths (``rename``: (port path, JAX path)) made equal."""
    assert cli_main([name, *[str(a) for a in args[0]]]) == 0
    got = capsys.readouterr().out
    want = _jax_cli(command, args[1])
    for p, j in rename:
        got = got.replace(str(p), str(j))
    return got, want


@pytest.mark.parametrize("flags", [[], ["--phonetisaurus", "--evaluate"],
                                   ["--reference_format"]],
                         ids=["pair_ngram", "phonetisaurus_evaluate",
                              "reference_format"])
def test_train_g2p_cli_matches_jax(spelled, tmp_path, capsys, flags):
    _tmp, dict_path, _train, _test = spelled
    got, want = tmp_path / "port.zip", tmp_path / "jax.zip"
    args = [dict_path, "--order", "4", "--num_alignment_iterations", "3",
            "--random_starts", "2", *flags]
    printed = _both(capsys, "train_g2p", JCLI.train_g2p_cli,
                    ([dict_path, got, *args[1:]], [dict_path, want, *args[1:]]),
                    rename=[(got, want)])
    assert printed[0] == printed[1]
    j_model, p_model = JModel.load(want), PModel.load(got)
    if "--reference_format" in flags:
        assert isinstance(p_model, POpenFst)
        assert p_model.generate("abc", 2) == j_model.generate("abc", 2)
    else:
        assert p_model.lm.ngrams == j_model.lm.ngrams
        assert p_model.meta == j_model.meta


@pytest.fixture(scope="module")
def g2p_model(spelled):
    tmp, dict_path, _train, _test = spelled
    path = tmp / "g2p.zip"
    PPair(order=4, num_random_starts=2).train_from_dictionary(dict_path).save(path)
    return path


def test_g2p_cli_matches_jax(spelled, g2p_model, tmp_path, capsys):
    tmp, dict_path, train, test = spelled
    word_list = tmp_path / "words.txt"
    word_list.write_text("\n".join(
        [w.upper() for w, _p in test[:8]] + [train[0][0], "[laughter]", "", "<unk>"]))
    corpus = tmp_path / "corpus" / "spk"
    corpus.mkdir(parents=True)
    (corpus / "a.lab").write_text(" ".join(w for w, _p in test[:5]) + " [noise]")
    (corpus / "b.txt").write_text(" ".join(w for w, _p in train[:4]))
    TextGrid(0.0, 1.0, {"words": [Interval(0.0, 1.0, test[6][0])]}).write(
        corpus / "c.TextGrid")
    config = tmp_path / "g2p.yaml"
    config.write_text("num_pronunciations: 2\nexport_scores: true\n")
    cases = [
        (word_list, []),
        (word_list, ["--num_pronunciations", "3", "--export_scores", "--sorted",
                     "--include_bracketed"]),
        (word_list, ["--dictionary_path", dict_path]),
        (word_list, ["--config_path", config]),
        (tmp_path / "corpus", []),
        (tmp_path / "corpus", ["--dictionary_path", dict_path, "--export_scores"]),
    ]
    for i, (src, flags) in enumerate(cases):
        got, want = tmp_path / f"port{i}.txt", tmp_path / f"jax{i}.txt"
        printed = _both(capsys, "g2p", JCLI.g2p_cli,
                        ([src, g2p_model, got, *flags], [src, g2p_model, want, *flags]),
                        rename=[(got, want)])
        assert printed[0] == printed[1], flags
        assert got.read_text() == want.read_text(), flags
        assert got.read_text(), flags


def test_validate_dictionary_cli_matches_jax(spelled, tmp_path, capsys):
    _tmp, dict_path, _train, _test = spelled
    bad = tmp_path / "bad.dict"
    # two entries whose pronunciations disagree with their spellings
    bad.write_text(dict_path.read_text() + "abcd\tp10 p11 p12 p13 p14 p15\n"
                   "efgh\tp20\n")
    for d in (dict_path, bad):
        got, want = _both(capsys, "validate_dictionary",
                          JCLI.validate_dictionary_cli,
                          ([d, "--order", "4"], [d, "--order", "4"]))
        assert got == want
    assert got.startswith("Validated 62 entries;")
