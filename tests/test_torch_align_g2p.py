"""The port's ``align`` and ``train`` with G2P, phonological rules and a
language tokenizer, against the JAX package's, on the CPU.

* ``apply_rules_to_lexicon`` and ``PhonologicalRule.load_rules``: the same
  variants.
* ``PretrainedAligner`` with ``g2p_model_path``, ``rules_path`` and
  ``language="english"``: on the mono fixture the same intervals as the
  JAX package's; on a small SAT fixture (``chip_smoke.py``'s g2p-align
  recipe at a tiny size, FLAC audio) the JAX package's parity bar and the
  same generated pronunciations; the long path adds G2P pronunciations
  too; no graph pool starts while G2P is on.
* A multi-dictionary argument: G2P pronunciations and rule variants reach
  every dictionary (the JAX package changes only the default one; ROADMAP
  Queue 3).
* ``TrainableAligner`` with rules, ``language="english"`` and a
  ``train_g2p`` pron_prob stage regenerates the JAX package's lexicon.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.io.flac as JF
import montreal_forced_aligner_tpu.online.alignment as JO
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.online.alignment as PO
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu.dictionary.lexicon import Lexicon as JLexicon
from montreal_forced_aligner_tpu.dictionary.rules import (
    PhonologicalRule as JRule,
)
from montreal_forced_aligner_tpu.dictionary.rules import (
    apply_rules_to_lexicon as j_apply,
)
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon as PLexicon
from montreal_forced_aligner_tpu_torch.dictionary.rules import (
    PhonologicalRule as PRule,
)
from montreal_forced_aligner_tpu_torch.dictionary.rules import (
    apply_rules_to_lexicon as p_apply,
)
from montreal_forced_aligner_tpu_torch.g2p.pair_ngram import PairNgramTrainer

from helpers import build_synthetic_corpus, build_synthetic_model
from test_training import make_training_corpus
from test_torch_train import write_dict

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

MONO_RULES = ("rules:\n  - segment: bb\n    following_context: $\n"
              "    replacement: aa\n  - segment: aa\n    preceding_context: ^\n"
              "    following_context: bb\n    replacement: ''\n")


def _intervals(results):
    return {k: ([(p.label, round(p.begin, 6), round(p.end, 6)) for p in a.phones],
                [(w.label, round(w.begin, 6), round(w.end, 6)) for w in a.words])
            for k, a in results.items()}


def _lexicon(lex):
    return {w: [(p.phones, p.probability) for p in prons]
            for w, prons in lex.words.items()}


@pytest.fixture(autouse=True)
def jax_python_flac(monkeypatch):
    """The JAX package decodes FLAC with its Python frame decoder here (its
    native loader would build a library inside the JAX package)."""
    monkeypatch.setattr(JF, "_decode_frames_native", lambda *a: None)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """The mono fixture with "ab" left out of its dictionary, a G2P model
    trained on spelled a/b words (a -> aa, b -> bb), and rules."""
    tmp = tmp_path_factory.mktemp("mono_g2p")
    corpus_dir, wave = build_synthetic_corpus(tmp, text="ab a ba")
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    no_ab = tmp / "no_ab.dict"
    no_ab.write_text("".join(line + "\n" for line in dict_path.read_text().splitlines()
                             if not line.startswith("ab\t")))
    spelled = tmp / "spelled.dict"
    words = ["aab", "abb", "bab", "aba", "bba", "baab", "abab", "bbaa", "aabb", "b",
             "a", "ba", "bbb", "aaa"]
    spelled.write_text("".join(
        f"{w}\t{' '.join('aa' if c == 'a' else 'bb' for c in w)}\n" for w in words))
    g2p = tmp / "g2p.zip"
    PairNgramTrainer(order=4, num_random_starts=2).train_from_dictionary(spelled).save(g2p)
    rules = tmp / "rules.yaml"
    rules.write_text(MONO_RULES)
    return tmp, corpus_dir, model_path, no_ab, g2p, rules


def test_rules_match_jax(mono, tmp_path):
    _tmp, _c, _m, no_ab, _g, rules = mono
    jrules, prules = JRule.load_rules(rules), PRule.load_rules(rules)
    assert [(r.segment, r.replacement, r.preceding_context, r.following_context)
            for r in prules] == [(r.segment, r.replacement, r.preceding_context,
                                  r.following_context) for r in jrules]
    for text in ("aa bb", "bb aa bb", "aa aa bb", "bb"):
        assert [r.apply(text) for r in prules] == [r.apply(text) for r in jrules]
    d = tmp_path / "d.dict"
    d.write_text(no_ab.read_text() + "abab\taa bb aa bb\naab\taa aa bb\n")
    jlex, plex = JLexicon.load(d), PLexicon.load(d)
    assert p_apply(plex, prules) == j_apply(jlex, jrules) > 0
    assert _lexicon(plex) == _lexicon(jlex)


def test_mono_align_with_g2p_rules_and_language_matches_jax(mono):
    _tmp, corpus_dir, model_path, no_ab, g2p, rules = mono
    kw = {"g2p_model_path": g2p, "rules_path": rules}
    jal = JA.PretrainedAligner(model_path, no_ab,
                               JA.AlignerConfig(batch_size=2, language="english"), **kw)
    pal = PA.PretrainedAligner(model_path, no_ab,
                               PA.AlignerConfig(batch_size=2, language="english"),
                               device="cpu", **kw)
    assert _lexicon(pal.lexicon) == _lexicon(jal.lexicon)
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    assert _intervals(got) == _intervals(want)
    assert [w.label for w in next(iter(got.values())).words] == ["ab", "a", "ba"]
    assert _lexicon(pal.lexicon) == _lexicon(jal.lexicon)
    assert [p.phones for p in pal.lexicon.words["ab"]] == [("aa", "bb")]


def test_align_cli_with_g2p_matches_jax_cli(mono, tmp_path):
    from click.testing import CliRunner

    import montreal_forced_aligner_tpu.cli as JCLI

    _tmp, corpus_dir, model_path, no_ab, g2p, rules = mono
    extra = ["--g2p_model_path", str(g2p), "--rules_path", str(rules),
             "--language", "english"]
    assert cli_main(["align", str(corpus_dir), str(no_ab), str(model_path),
                     str(tmp_path / "port"), "--device", "cpu", *extra]) == 0
    out = CliRunner().invoke(JCLI.align_cli, [str(corpus_dir), str(no_ab),
                                              str(model_path), str(tmp_path / "jax"),
                                              *extra], catch_exceptions=False)
    assert out.exit_code == 0, out.output
    got = sorted((tmp_path / "port").rglob("*.TextGrid"))
    want = sorted((tmp_path / "jax").rglob("*.TextGrid"))
    assert [p.name for p in got] == [p.name for p in want] and got
    for a, b in zip(got, want):
        assert a.read_text() == b.read_text()


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    """``chip_smoke.py``'s g2p-align recipe at a tiny size: a SAT model over
    6 phones, 6 FLAC utterances over 2 speakers, a spelled dictionary of 40
    words (10 held out), its rules and a G2P model."""
    tmp = tmp_path_factory.mktemp("sat_g2p")
    model_path, _d, words = chip_smoke.build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20)
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 6, min_s=2.5, max_s=5.0,
                                            num_speakers=2)
    fx = chip_smoke.build_g2p_fixture(tmp / "g2p", [f"p{i:02d}" for i in range(6)],
                                      corpus_dir, subset=3, num_words=40,
                                      held_out=10)
    PairNgramTrainer(order=4, num_random_starts=2).train_from_dictionary(
        fx["dict_path"]).save(fx["g2p_path"])
    return model_path, fx


def test_sat_two_pass_with_g2p_meets_parity_bar(sat):
    model_path, fx = sat
    jal = JA.PretrainedAligner(model_path, fx["dict_path"],
                               JA.AlignerConfig(batch_size=4, language="english"),
                               g2p_model_path=fx["g2p_path"],
                               rules_path=fx["rules_path"])
    want = jal.align_corpus(JCorpus.load(fx["flac_dir"]))
    got, entries = chip_smoke.g2p_align_run(model_path, fx, fx["flac_dir"], "cpu",
                                            batch_size=4)
    assert entries == {w: [p.phones for p in jal.lexicon.words[w]]
                       for w in fx["held_out"] if w in jal.lexicon.words}
    assert entries
    report = chip_smoke.parity(got, want, 0.01)
    assert report["frames"] > 1000
    labels = {w.label for a in got.values() for w in a.words}
    assert labels & set(fx["held_out"])


def test_long_path_adds_g2p_pronunciations(mono, monkeypatch):
    _tmp, corpus_dir, model_path, no_ab, g2p, rules = mono
    monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", 50)
    monkeypatch.setattr(JO, "LONG_UTTERANCE_FRAMES", 50)
    calls = []
    orig = PO.align_utterance_online
    monkeypatch.setattr(PO, "align_utterance_online",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    kw = {"g2p_model_path": g2p, "rules_path": rules}
    pal = PA.PretrainedAligner(model_path, no_ab, device="cpu", **kw)
    jal = JA.PretrainedAligner(model_path, no_ab, **kw)
    assert "ab" not in pal.lexicon.words
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    assert calls and "ab" in pal.lexicon.words
    assert _intervals(got) == _intervals(want)


def test_no_graph_pool_while_g2p_is_on(mono, monkeypatch):
    _tmp, corpus_dir, model_path, no_ab, g2p, _rules = mono
    cfg = PA.AlignerConfig(num_graph_workers=2)
    with_g2p = PA.PretrainedAligner(model_path, no_ab, cfg, g2p_model_path=g2p,
                                    device="cpu")
    assert with_g2p._graph_pool(1000) is None
    plain = PA.PretrainedAligner(model_path, no_ab, cfg, device="cpu")
    # without G2P the pool would start (stopped before it spawns workers)
    started = []
    import montreal_forced_aligner_tpu_torch.graph.parallel as GP

    monkeypatch.setattr(GP, "ParallelGraphCompiler",
                        lambda compilers, n: started.append(n) or object())
    assert plain._graph_pool(1000) is not None and started == [2]


def test_g2p_and_rules_reach_every_dictionary(mono, tmp_path):
    """A speaker mapped to a second dictionary: its OOV word gets a G2P
    pronunciation and its words the rules' variants in the port; the JAX
    package adds both to the default dictionary only, so that speaker's
    word stays OOV there."""
    _tmp, corpus_dir, model_path, no_ab, g2p, rules = mono
    other = tmp_path / "other.dict"
    other.write_text(no_ab.read_text())
    mapping = tmp_path / "dicts.yaml"
    mapping.write_text(f"default: {no_ab}\nspk1: {other}\n")
    kw = {"g2p_model_path": g2p, "rules_path": rules}
    pal = PA.PretrainedAligner(model_path, mapping, device="cpu", **kw)
    jal = JA.PretrainedAligner(model_path, mapping, **kw)
    p_other, j_other = pal.lexicons[str(other)], jal.lexicons[str(other)]
    assert _lexicon(p_other) == _lexicon(pal.lexicons[str(no_ab)])
    assert _lexicon(j_other) != _lexicon(jal.lexicons[str(no_ab)])
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    assert "ab" in p_other.words and "ab" not in j_other.words
    assert [w.label for w in next(iter(got.values())).words] == ["ab", "a", "ba"]
    assert [w.label for w in next(iter(want.values())).words][0] == "<unk>"


def test_train_with_rules_language_and_train_g2p_matches_jax(tmp_path):
    from montreal_forced_aligner_tpu.training.base import TrainerConfig as JCfg
    from montreal_forced_aligner_tpu.training.trainer import StageConfig as JStage
    from montreal_forced_aligner_tpu.training.trainer import (
        TrainableAligner as JTrainable,
    )
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig as PCfg
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig as PStage,
    )
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        TrainableAligner as PTrainable,
    )

    corpus_dir, _truths = make_training_corpus(tmp_path, n_utts=6)
    dict_path = write_dict(tmp_path / "train.dict")
    rules = tmp_path / "rules.yaml"
    rules.write_text(chip_smoke.TRAIN_G2P_RULES)
    name, kind, iters, gauss, _leaves = chip_smoke.TINY_RECIPE[0]
    out = {}
    for side, Trainable, Stage, Cfg, kw in (
            ("jax", JTrainable, JStage, JCfg, {}),
            ("port", PTrainable, PStage, PCfg, {"device": "cpu"})):
        ta = Trainable(corpus_dir, dict_path,
                       recipe=[Stage(name, kind, iters, gauss),
                               Stage("pron_prob", "pron_prob", 0, 0, train_g2p=True)],
                       base_config=Cfg(boost_silence=1.0), batch_size=4,
                       variable_length_topology=False, rules_path=rules,
                       language="english", **kw)
        before = _lexicon(ta.lexicon)
        ta.train()
        out[side] = (before, _lexicon(ta.lexicon), ta.g2p_models[0].lm.ngrams)
    assert out["port"] == out["jax"]
    before, after, _ngrams = out["port"]
    assert ("bb",) in [p for p, _prob in before["ba"]]  # the rule's variant
    assert after != before


def test_cli_train_with_g2p_options_runs(tmp_path, capsys):
    make_training_corpus(tmp_path, n_utts=4)
    dict_path = write_dict(tmp_path / "train.dict")
    rules = tmp_path / "rules.yaml"
    rules.write_text(chip_smoke.TRAIN_G2P_RULES)
    cfg = tmp_path / "recipe.yaml"
    cfg.write_text("training:\n  - monophone:\n      num_iterations: 2\n"
                   "      max_gaussians: 20\n  - pronunciation_probabilities:\n"
                   "      train_g2p: false\n")
    out = tmp_path / "m.zip"
    assert cli_main(["train", str(tmp_path / "train_corpus"), str(dict_path),
                     str(out), "--device", "cpu", "--config_path", str(cfg),
                     "--batch_size", "2", "--chain_topology", "--rules_path",
                     str(rules), "--language", "english", "--train_g2p"]) == 0
    assert "Saved model" in capsys.readouterr().out and out.exists()
    assert np.isfinite(PA.AcousticModel.load(out).gmm.gconsts).any()
