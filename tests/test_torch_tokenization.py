"""The port's language tokenizers and trainable tokenizer against the JAX
package's, on the CPU.

* ``get_language_tokenizer`` for every language, composed with the simple
  tokenizer, on the JAX tests' golden strings
  (``tests/test_language_tokenizers.py``): identical tokens, equal to the
  goldens; the gated engines (ja/zh/ko/th, spacy) through the interface
  mocks of ``tests/mock_tokenizer_engines.py``, as
  ``tests/test_tokenizer_surface.py`` runs them.
* ``TokenizerTrainer`` models cross packages both ways, and the
  ``train_tokenizer`` and ``tokenize`` commands write the same files and
  print the same lines as the JAX CLI's.
"""

import sys

import pytest
from click.testing import CliRunner

import montreal_forced_aligner_tpu.cli as JCLI
import montreal_forced_aligner_tpu.tokenization.languages as JL
import montreal_forced_aligner_tpu_torch.tokenization.languages as PL
from montreal_forced_aligner_tpu.dictionary.tokenizer import (
    SimpleTokenizer as JSimple,
)
from montreal_forced_aligner_tpu.g2p.trainer import G2PModel as JG2PModel
from montreal_forced_aligner_tpu.tokenization.trainer import (
    TokenizerTrainer as JTrainer,
)
from montreal_forced_aligner_tpu.tokenization.trainer import (
    TrainedTokenizer as JTrained,
)
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import (
    SimpleTokenizer as PSimple,
)
from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel as PG2PModel
from montreal_forced_aligner_tpu_torch.tokenization.trainer import (
    TokenizerTrainer as PTrainer,
)
from montreal_forced_aligner_tpu_torch.tokenization.trainer import (
    TrainedTokenizer as PTrained,
)
from montreal_forced_aligner_tpu_torch.tokenization_surface import (
    TOKENIZATION_SURFACE,
    check_surface,
)

from mock_tokenizer_engines import all_mocks

# (language, vocabulary, [(text, golden tokens)]): the JAX tests' goldens
GOLDEN = {
    "english": ("english", {"going", "home", "render", "-ing", "cat", "-s",
                            "non-stop"},
                [("Goin' home!", ["going", "home"]),
                 ("rendering cats", ["render", "-ing", "cat", "-s"]),
                 ("non - stop", ["non-stop"])]),
    "english_prefix": ("en", {"do", "re-", "stop", "non-"},
                       [("redo nonstop", ["re-", "do", "non-", "stop"])]),
    "japanese": ("japanese", {
        "今日", "は", "いい", "天気", "です", "ね", "明日", "雨", "が", "降る",
        "かも", "しれ", "ませ", "ん", "はい", "何", "でしょう"},
        [("今日はいい天気ですね。明日は雨が降るかもしれません。",
          ["今日", "は", "いい", "天気", "です", "ね", "明日", "は", "雨", "が",
           "降る", "かも", "しれ", "ませ", "ん"]),
         ("「はい」、。！ 『何 でしょう』", ["はい", "何", "でしょう"]),
         ("はい[laughter]何でしょう", ["はい", "[laughter]", "何", "でしょう"])]),
    "japanese_fixture": ("ja", {
        "真っ昼間", "な", "の", "に", "キャンプ", "外れ", "電柱", "電球", "が",
        "ともっ", "て", "い", "た"},
        [("真っ昼間なのにキャンプの外れの電柱に電球がともっていた",
          ["真っ昼間", "な", "の", "に", "キャンプ", "の", "外れ", "の", "電柱",
           "に", "電球", "が", "ともっ", "て", "い", "た"])]),
    "chinese": ("chinese", {
        "我们", "今天", "去", "公园", "玩", "天气", "很", "好", "他", "喜欢",
        "北京", "大学", "北京大学", "的", "学生", "都", "在", "图书馆", "看",
        "书", "朋友"},
        [("我们今天去公园玩，天气很好。",
          ["我们", "今天", "去", "公园", "玩", "天气", "很", "好"]),
         ("北京大学的学生都在图书馆看书！",
          ["北京大学", "的", "学生", "都", "在", "图书馆", "看", "书"]),
         ("他喜欢北京的朋友", ["他", "喜欢", "北京", "的", "朋友"]),
         ("我们 今天 去 公园", ["我们", "今天", "去", "公园"])]),
    "korean": ("korean", {"안녕", "하세요", "저", "는", "학생", "입니다", "한국",
                          "사람"},
               [("안녕하세요 저는 학생입니다",
                 ["안녕", "하세요", "저", "는", "학생", "입니다"]),
                ("한국사람입니다", ["한국", "사람", "입니다"])]),
    "thai": ("thai", {"วันนี้", "อากาศ", "ดี", "มาก", "ฉัน", "ไป", "โรงเรียน",
                      "กับ", "เพื่อน", "เรา", "กิน", "ข้าว", "ที่", "ร้าน"},
             [("วันนี้อากาศดีมาก", ["วันนี้", "อากาศ", "ดี", "มาก"]),
              ("ฉันไปโรงเรียนกับเพื่อน", ["ฉัน", "ไป", "โรงเรียน", "กับ", "เพื่อน"]),
              ("วันนี้ อากาศดี", ["วันนี้", "อากาศ", "ดี"])]),
}


def _tokenizers(lang, words):
    jax = JL.compose_tokenizer(JSimple(word_set=words),
                               JL.get_language_tokenizer(lang, word_set=words))
    port = PL.compose_tokenizer(PSimple(word_set=words),
                                PL.get_language_tokenizer(lang, word_set=words))
    return jax, port


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_language_tokenizers_match_jax_goldens(case):
    lang, words, texts = GOLDEN[case]
    jax, port = _tokenizers(lang, words)
    assert type(port._lang).__name__ == type(jax._lang).__name__
    for text, golden in texts:
        assert port.tokenize(text) == jax.tokenize(text) == golden


@pytest.mark.parametrize("word,vocab", [
    ("rendering", {"render", "-ing"}), ("baking", {"bake", "-ing"}),
    ("running", {"run", "-ing"}), ("happiness", {"happy", "-ness"}),
    ("printability", {"print", "-ability"}), ("remarkably", {"remark", "-ly"}),
    ("walked", {"walk", "-ed"}), ("running", {"running", "run", "-ing"}),
    ("zorping", {"-ing"}), ("rendering", {"render"}),
])
def test_english_suffix_splits_match_jax(word, vocab):
    assert (PL.EnglishTokenizer(word_set=vocab).pre_tokenize(word)
            == JL.EnglishTokenizer(word_set=vocab).pre_tokenize(word))


def test_factory_and_fallbacks_match_jax():
    for lang in (None, "unknown", "klingon"):
        assert PL.get_language_tokenizer(lang) is None
        assert JL.get_language_tokenizer(lang) is None
    for lang in PL._LANGUAGES:
        assert type(PL.get_language_tokenizer(lang)).__name__ == type(
            JL.get_language_tokenizer(lang)).__name__
    simple = PSimple(word_set={"a"})
    assert PL.compose_tokenizer(simple, None) is simple
    # no engine installed: identity, as the JAX package's
    for cls in ("JapaneseTokenizer", "ChineseTokenizer", "KoreanTokenizer",
                "ThaiTokenizer"):
        text = "こんにちは 世界"
        assert (getattr(PL, cls)().pre_tokenize(text)
                == getattr(JL, cls)().pre_tokenize(text) == text)
    text = "hello [no speech] there <cut off wor>"
    assert (PL.EnglishTokenizer(word_set={"hello"}).pre_tokenize(text)
            == JL.EnglishTokenizer(word_set={"hello"}).pre_tokenize(text))


@pytest.fixture
def engine_mocks(monkeypatch):
    mods = all_mocks()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods


@pytest.mark.parametrize("lang,words,text", [
    ("japanese", {"何"}, "何です。"),
    ("chinese", {"我们"}, "我们今天去"),
    ("korean", {"안녕"}, "안녕 하세요"),
    ("thai", {"อากาศ"}, "อากาศดี"),
    ("english", {"going", "home"}, "goin' home"),
], ids=["japanese", "chinese", "korean", "thai", "english"])
def test_gated_engines_match_jax_under_mocks(engine_mocks, lang, words, text):
    assert check_surface(lambda p: engine_mocks[p]) == []
    assert set(TOKENIZATION_SURFACE) <= set(engine_mocks)
    port = PL.get_language_tokenizer(lang, word_set=words)
    jax = JL.get_language_tokenizer(lang, word_set=words)
    if lang != "english":
        assert port._impl is not None and jax._impl is not None
    assert port.pre_tokenize(text) == jax.pre_tokenize(text)


TOKENIZER_PAIRS = [
    ("thecatsat", "the cat sat"), ("adogran", "a dog ran"),
    ("thedogsat", "the dog sat"), ("acatran", "a cat ran"),
    ("thecatran", "the cat ran"), ("adogsat", "a dog sat"),
    ("thebirdsang", "the bird sang"), ("abirdsat", "a bird sat"),
    ("thecatsang", "the cat sang"), ("adogsang", "a dog sang"),
    ("thebirdran", "the bird ran"), ("acatsat", "a cat sat"),
]


def test_tokenizer_models_cross_packages(tmp_path):
    jtok = JTrainer(order=4).train_from_pairs(TOKENIZER_PAIRS)
    ptok = PTrainer(order=4).train_from_pairs(TOKENIZER_PAIRS)
    assert ptok.model.lm.ngrams == jtok.model.lm.ngrams
    jtok.model.save(tmp_path / "j.zip")
    ptok.model.save(tmp_path / "p.zip")
    for raw in ("thebirdsat", "acatsang", "thedogran"):
        want = jtok.tokenize(raw)
        assert ptok.tokenize(raw) == want
        assert PTrained(model=PG2PModel.load(tmp_path / "j.zip")).tokenize(raw) == want
        assert JTrained(model=JG2PModel.load(tmp_path / "p.zip")).tokenize(raw) == want


def test_train_tokenizer_and_tokenize_cli_match_jax(tmp_path, capsys):
    train = tmp_path / "pairs.txt"
    train.write_text("".join(f"{r}\t{t}\n" for r, t in TOKENIZER_PAIRS))
    text = tmp_path / "in.txt"
    text.write_text("thebirdsat\nacatsang\n")
    runner = CliRunner()
    outs = {}
    for who in ("port", "jax"):
        model, tokenized = tmp_path / f"{who}.zip", tmp_path / f"{who}.txt"
        args = [str(train), str(model), "--order", "4", "--evaluate"]
        if who == "port":
            assert cli_main(["train_tokenizer", *args]) == 0
            assert cli_main(["tokenize", str(text), str(model), str(tokenized)]) == 0
            printed = capsys.readouterr().out
        else:
            r1 = runner.invoke(JCLI.train_tokenizer_cli, args, catch_exceptions=False)
            r2 = runner.invoke(JCLI.tokenize_cli, [str(text), str(model),
                                                   str(tokenized)],
                               catch_exceptions=False)
            assert r1.exit_code == r2.exit_code == 0
            printed = r1.output + r2.output
        outs[who] = (printed.replace(str(tmp_path / who), "OUT"),
                     tokenized.read_text(),
                     PG2PModel.load(model).lm.ngrams)
    assert outs["port"] == outs["jax"]
    assert "Evaluation on 1 held-out lines" in outs["port"][0]
