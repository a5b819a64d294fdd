"""The port's phone transcription (``transcription/phone_transcriber.py``,
``align --use_phone_model``), ``validate --test_transcriptions`` and
``online/transcription.py`` against the JAX package's, on the CPU.

* ``transcribe_phones`` on the same alignments: identical phone labels and
  times; ``evaluate_against_alignments`` on the same inputs: equal scores
  and CSV.
* ``align --use_phone_model`` (with ``--fine_tune``, which it supersedes)
  and ``validate --test_transcriptions``: the same PER, WER and flagged
  utterances as the JAX package's commands print.
* ``transcribe_utterance_online``: the same transcript as the JAX
  package's; its neural variants raise.
"""

import re

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import montreal_forced_aligner_tpu.online.transcription as JOT
import montreal_forced_aligner_tpu.transcription.phone_transcriber as JPH
import montreal_forced_aligner_tpu_torch.online.transcription as POT
import montreal_forced_aligner_tpu_torch.transcription.phone_transcriber as PPH
from montreal_forced_aligner_tpu.align.aligner import (
    AlignerConfig as JConfig,
    PretrainedAligner as JAligner,
)
from montreal_forced_aligner_tpu.cli import cli as jax_cli
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.align.aligner import (
    AlignerConfig as PConfig,
    PretrainedAligner as PAligner,
)
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.data import CtmInterval as PCtm

from helpers import build_synthetic_model, synth_wave
from test_torch_transcription import make_corpus


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The decoders' per-frame loops launch many small ops; under pytest's
    parallel workers, each with a full intra-op thread pool, the pools
    oversubscribe the cores and every op's barrier waits on descheduled
    threads. One thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("phone_tr")
    corpus_dir, wave = make_corpus(tmp, n=3)
    # one utterance whose transcript disagrees with its audio
    (corpus_dir / "spk0" / "utt2.lab").write_text("b ba b")
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return tmp, corpus_dir, model_path, dict_path


def _intervals(x):
    return {k: [(p.label, round(p.begin, 6), round(p.end, 6)) for p in v]
            for k, v in x.items()}


def test_transcribe_phones_and_evaluation_match_jax(mono, tmp_path):
    _tmp, corpus_dir, model_path, dict_path = mono
    ja = JAligner(model_path, dict_path, JConfig(batch_size=2))
    pa = PAligner(model_path, dict_path, PConfig(batch_size=2), device="cpu")
    jc, pc = JCorpus.load(corpus_dir), PCorpus.load(corpus_dir)
    jres, pres = ja.align_corpus(jc), pa.align_corpus(pc)
    assert _intervals({k: v.phones for k, v in jres.items()}) == _intervals(
        {k: v.phones for k, v in pres.items()})
    jt = JPH.transcribe_phones(model_path, jc, jres, batch_size=2)
    pt = PPH.transcribe_phones(model_path, pc, pres, batch_size=2, device="cpu")
    assert _intervals(pt) == _intervals(jt)
    assert [p.label for p in pt[0] if p.label != "sil"] == [
        p.label for p in pres[0].phones if p.label != "sil"]
    jo, jper = JPH.evaluate_against_alignments(jres, jt, jc, tmp_path / "j.csv")
    po, pper = PPH.evaluate_against_alignments(pres, pt, pc, tmp_path / "p.csv")
    assert (po, pper) == (jo, jper)
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    # the archive's bundled phone LM replaces the one trained here
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        train_phone_lm,
    )

    lm = train_phone_lm(pres, order=2)
    again = PPH.transcribe_phones(model_path, pc, pres, batch_size=2,
                                  phone_lm=lm, device="cpu")
    assert set(again) == set(pt)
    assert PPH.transcribe_phones(model_path, pc, {}, device="cpu") == {}


def test_evaluate_against_alignments_matches_jax_on_fixed_inputs(tmp_path):
    from montreal_forced_aligner_tpu.data import CtmInterval as JCtm

    rng = np.random.RandomState(4)

    class Aln:
        def __init__(self, phones):
            self.phones = phones

    class Utt:
        def __init__(self, i):
            self.id, self.file_name, self.begin, self.end = i, f"f{i}", 0.0, 2.0
            self.speaker = "s"

    class Corp:
        utterances = [Utt(i) for i in range(4)]

    def seq(cls, labels, shift):
        t = 0.0
        out = []
        for lab in labels:
            d = 0.05 + 0.01 * shift
            out.append(cls(round(t, 4), round(t + d, 4), lab))
            t += d
        return out

    ref = {i: [str(x) for x in rng.choice(["aa", "bb", "sil", "cc"], 8)]
           for i in range(4)}
    hyp = {i: [str(x) for x in rng.choice(["aa", "bb", "cc"], 7)] for i in range(3)}
    jr = {i: Aln(seq(JCtm, v, 0)) for i, v in ref.items()}
    pr = {i: Aln(seq(PCtm, v, 0)) for i, v in ref.items()}
    jh = {i: seq(JCtm, v, 1) for i, v in hyp.items()}
    ph = {i: seq(PCtm, v, 1) for i, v in hyp.items()}
    want = JPH.evaluate_against_alignments(jr, jh, Corp(), tmp_path / "j.csv")
    got = PPH.evaluate_against_alignments(pr, ph, Corp(), tmp_path / "p.csv")
    assert got == want
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()


def _line(out: str, prefix: str) -> str:
    return next(l for l in out.splitlines() if l.startswith(prefix))


def test_align_use_phone_model_matches_jax(mono, tmp_path, capsys):
    _tmp, corpus_dir, model_path, dict_path = mono
    args = ["align", str(corpus_dir), str(dict_path), str(model_path)]
    r = CliRunner().invoke(jax_cli, args + [str(tmp_path / "j"),
                                            "--use_phone_model", "--fine_tune",
                                            "--batch_size", "2"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert cli_main(args + [str(tmp_path / "p"), "--use_phone_model",
                            "--fine_tune", "--batch_size", "2",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "supersedes --fine_tune" in out
    assert _line(out, "Phone-transcript evaluation") == _line(
        r.output, "Phone-transcript evaluation")
    csv = "phone_transcript_evaluation.csv"
    assert (tmp_path / "p" / csv).read_text() == (tmp_path / "j" / csv).read_text()
    # superseded: boundaries stay on the 10 ms grid
    tg = (tmp_path / "p" / "utt0.TextGrid").read_text()
    times = [float(x) for x in re.findall(r"xmin = ([0-9.]+)", tg)]
    assert all(abs(t * 100 - round(t * 100)) < 1e-6 for t in times)


def test_validate_test_transcriptions_matches_jax(mono, capsys):
    _tmp, corpus_dir, model_path, dict_path = mono
    args = ["validate", str(corpus_dir), str(dict_path), "--acoustic_model_path",
            str(model_path), "--test_transcriptions"]
    r = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert cli_main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _line(out, "Transcription check") == _line(r.output,
                                                       "Transcription check")
    flagged = [l for l in out.splitlines() if "WER" in l and l.startswith("  ")]
    assert flagged == [l for l in r.output.splitlines()
                       if "WER" in l and l.startswith("  ")]
    assert "Validation complete" in out
    # without a model the check refuses
    assert cli_main(["validate", str(corpus_dir), str(dict_path),
                     "--test_transcriptions", "--device", "cpu"]) == 1


def test_online_transcription_matches_jax(mono, tmp_path):
    _tmp, _cd, model_path, dict_path = mono
    samples = synth_wave()
    lm_path = tmp_path / "lm.arpa"
    from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
        train_lm_from_texts,
    )

    train_lm_from_texts(["ab a", "ab", "a b"], order=2)[0].write(lm_path)
    for kw in ({}, {"language_model_path": lm_path}):
        want = JOT.transcribe_utterance_online(model_path, dict_path, samples, **kw)
        got = POT.transcribe_utterance_online(model_path, dict_path, samples,
                                              device="cpu", **kw)
        assert got.text == want.text
        assert abs(got.log_likelihood - want.log_likelihood) < 5.0
    assert got.text == "ab a"
    # the neural variants run (tests/test_torch_whisper.py and
    # tests/test_torch_speechbrain.py hold them against the JAX package's);
    # here their errors without a checkpoint or the package
    with pytest.raises(FileNotFoundError, match="no local Whisper checkpoint"):
        POT.transcribe_utterance_online_whisper(tmp_path / "none", samples,
                                                device="cpu")
    with pytest.raises(RuntimeError, match="speechbrain is not available"):
        POT.transcribe_utterance_online_speechbrain(tmp_path, samples, device="cpu")
