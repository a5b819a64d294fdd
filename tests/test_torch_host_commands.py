"""The port's host commands and command-line repairs, on the CPU, against
the JAX package's commands on the same inputs.

* ``-j/--num_jobs`` on ``align``, ``align_one`` and ``train`` (``adapt``:
  ``tests/test_torch_adapt.py``); every option of the JAX package's
  ``align`` parses (it works or raises ``NotImplementedError`` naming its
  item, never argparse's "unrecognized arguments"); ``train``'s
  ``--no_clean`` and ``--features_on_device``; ``AlignerConfig()`` resolves
  its transfer mode to "waves".
* ``evaluate_alignments`` and ``align --reference_directory``: the same
  scores as the JAX package's; ``train_lm``: the same ARPA text, alone and
  in the archive; ``train_dictionary``: the same dictionary file;
  ``validate`` (with ``--rules_path``): the same OOV reports; ``model
  inspect`` the same summary;
  ``model add/save/add_words/list/download``, ``version``, ``configure``
  and ``history`` on temporary stores.
"""

import json
import zipfile

import pytest
from click.testing import CliRunner

import montreal_forced_aligner_tpu.cli as JCLI
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.cli as PCLI
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus

from helpers import build_synthetic_corpus, build_synthetic_model
from test_training import make_training_corpus
from test_torch_train import write_dict


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    """Model registry, profiles and history in this test's directory."""
    monkeypatch.setenv("MFA_TPU_MODEL_ROOT", str(tmp_path / "models"))
    monkeypatch.setenv("MFA_TPU_TEMP_DIR", str(tmp_path / "mfa"))
    monkeypatch.delenv("MFA_TPU_MODEL_MIRROR", raising=False)
    import montreal_forced_aligner_tpu_torch.config as PC

    monkeypatch.setattr(PC, "_config", None)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_commands")
    corpus_dir, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return tmp, corpus_dir, model_path, dict_path


@pytest.fixture(scope="module")
def tones(tmp_path_factory):
    """The JAX training test's tone corpus, with an OOV word in one
    transcript, and its dictionary."""
    tmp = tmp_path_factory.mktemp("host_tones")
    corpus_dir, _truths = make_training_corpus(tmp)
    lab = sorted(corpus_dir.rglob("*.lab"))[0]
    lab.write_text(lab.read_text() + " zzyzx")
    return tmp, corpus_dir, write_dict(tmp / "train.dict")


def jax_run(command, args):
    out = CliRunner().invoke(command, [str(a) for a in args], catch_exceptions=False)
    assert out.exit_code == 0, out.output
    return out.output


def test_num_jobs_on_align_and_align_one(mono, tmp_path, capsys):
    _tmp, corpus_dir, model_path, dict_path = mono
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                     str(tmp_path / "out"), "--device", "cpu", "-j", "4"]) == 0
    assert len(list((tmp_path / "out").rglob("*.TextGrid"))) == 1
    wav = next(corpus_dir.rglob("*.wav"))
    assert cli_main(["align_one", str(wav), str(wav.with_suffix(".lab")),
                     str(dict_path), str(model_path), str(tmp_path / "one.TextGrid"),
                     "--device", "cpu", "--num_jobs", "4"]) == 0
    assert (tmp_path / "one.TextGrid").exists()


def test_num_jobs_and_negative_flags_on_train(tmp_path, capsys):
    make_training_corpus(tmp_path, n_utts=2)
    dict_path = write_dict(tmp_path / "train.dict")
    cfg = tmp_path / "mono.yaml"
    cfg.write_text("training:\n  - monophone:\n      num_iterations: 2\n"
                   "      max_gaussians: 20\n")
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "stale.txt").write_text("kept")
    out = tmp_path / "m.zip"
    assert cli_main(["train", str(tmp_path / "train_corpus"), str(dict_path),
                     str(out), "--device", "cpu", "--config_path", str(cfg),
                     "--batch_size", "2", "-j", "3", "--no_clean",
                     "--features_on_device", "--no_distributed",
                     "--working_directory", str(wd)]) == 0
    assert out.exists() and (wd / "stale.txt").exists()
    args = PCLI._parser().parse_args(
        ["train", "c", "d", "m", "--features_on_host", "--features_on_device",
         "--clean", "--no_clean"])
    assert args.features_on_host is False and args.clean is False


def _jax_align_options():
    for param in JCLI.align_cli.params:
        if param.param_type_name != "option":
            continue
        for opt in param.opts + param.secondary_opts:
            yield param, opt


def test_every_jax_align_option_parses():
    parser = PCLI._parser()
    values = {"transfer_mode": "waves", "output_format": "json"}
    seen = 0
    for param, opt in _jax_align_options():
        argv = ["align", "c", "d", "m", "o", opt]
        if not param.is_flag:
            argv.append(values.get(param.name, "3"))
        parser.parse_args(argv)  # argparse exits on an unknown option
        seen += 1
    assert seen > 25


def test_aligner_config_resolves_to_waves(mono):
    """"auto" resolves to waves on the CPU; "features" (ported with the
    transfer mode) ships host features and aligns at the JAX transfer
    test's bar against waves."""
    from test_torch_transfer_mode import jax_transfer_bar

    _tmp, corpus_dir, model_path, dict_path = mono
    assert PA.AlignerConfig().transfer_mode == "auto"
    aligner = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    waves = aligner.align_corpus(PCorpus.load(corpus_dir))
    assert aligner.last_transfer_mode == "waves"
    assert PA.resolve_transfer_mode("waves") == "waves"
    assert PA.resolve_transfer_mode("features") == "features"
    aligner = PA.PretrainedAligner(model_path, dict_path,
                                   PA.AlignerConfig(transfer_mode="features"),
                                   device="cpu")
    jax_transfer_bar(waves, aligner.align_corpus(PCorpus.load(corpus_dir)))
    assert aligner.last_transfer_mode == "features"


def test_evaluate_alignments_matches_jax(mono, tmp_path, capsys):
    _tmp, corpus_dir, model_path, dict_path = mono
    ref = tmp_path / "ref"
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                     str(ref), "--device", "cpu"]) == 0
    test = tmp_path / "test"
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                     str(test), "--device", "cpu", "--boost_silence", "4.0",
                     "--reference_directory", str(ref)]) == 0
    align_out = capsys.readouterr().out
    mapping = tmp_path / "map.yaml"
    mapping.write_text("a: [a, b]\n")
    scores = []
    for extra in ([], ["--custom_mapping_path", str(mapping)]):
        assert cli_main(["evaluate_alignments", str(ref), str(test), *extra]) == 0
        got = capsys.readouterr().out
        want = jax_run(JCLI.evaluate_alignments_cli, [ref, test, *extra])
        assert got == want
        assert "Mean phone error rate" in got
        scores.append(got)
    # align --reference_directory printed the same scores
    assert align_out.endswith(scores[0])


@pytest.mark.parametrize("suffix", [".arpa", ".zip"])
def test_train_lm_matches_jax(tones, tmp_path, suffix, capsys):
    _tmp, corpus_dir, dict_path = tones
    got, want = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    assert cli_main(["train_lm", str(corpus_dir), str(got), "--order", "2",
                     "--dictionary_path", str(dict_path), "-j", "2"]) == 0
    jax_run(JCLI.train_lm_cli, [corpus_dir, want, "--order", "2",
                                "--dictionary_path", dict_path])
    if suffix == ".arpa":
        assert got.read_text() == want.read_text()
        return
    with zipfile.ZipFile(got) as g, zipfile.ZipFile(want) as w:
        gnames = sorted(n for n in g.namelist() if n.endswith(".arpa"))
        wnames = sorted(n for n in w.namelist() if n.endswith(".arpa"))
        assert [n.replace("port", "") for n in gnames] == [
            n.replace("jax", "") for n in wnames]
        assert len(gnames) == 3
        for a, b in zip(gnames, wnames):
            assert g.read(a) == w.read(b)


def test_train_dictionary_matches_jax(mono, tmp_path, capsys):
    _tmp, corpus_dir, model_path, dict_path = mono
    for flag in ([], ["--no_silence_probabilities"]):
        got, want = tmp_path / "port.dict", tmp_path / "jax.dict"
        assert cli_main(["train_dictionary", str(corpus_dir), str(dict_path),
                         str(model_path), str(got), "--device", "cpu",
                         *flag]) == 0
        jax_run(JCLI.train_dictionary_cli,
                [corpus_dir, dict_path, model_path, want, *flag])
        assert got.read_text() == want.read_text()


def test_validate_matches_jax(tones, tmp_path, capsys):
    _tmp, corpus_dir, dict_path = tones
    got, want = tmp_path / "port", tmp_path / "jax"
    assert cli_main(["validate", str(corpus_dir), str(dict_path),
                     "--output_directory", str(got), "-j", "2"]) == 0
    out = capsys.readouterr().out
    jout = jax_run(JCLI.validate_cli, [corpus_dir, dict_path,
                                       "--output_directory", want])
    for name in ("oovs_found.txt", "utterance_oovs.txt"):
        assert (got / name).read_text() == (want / name).read_text()
    assert "zzyzx\t1" in (got / "oovs_found.txt").read_text()
    assert out.replace(str(got), str(want)) == jout
    # --test_transcriptions works (tests/test_torch_phone_transcription.py);
    # without an acoustic model it refuses, as the JAX package's does
    assert cli_main(["validate", str(corpus_dir), str(dict_path),
                     "--test_transcriptions"]) == 1
    # --rules_path applies the rules before validating, as the JAX package's
    rules = tmp_path / "rules.yaml"
    rules.write_text("rules:\n  - segment: bb\n    following_context: $\n"
                     "    replacement: aa\n")
    got, want = tmp_path / "port_rules", tmp_path / "jax_rules"
    assert cli_main(["validate", str(corpus_dir), str(dict_path),
                     "--output_directory", str(got), "--rules_path",
                     str(rules)]) == 0
    out = capsys.readouterr().out
    jout = jax_run(JCLI.validate_cli, [corpus_dir, dict_path, "--output_directory",
                                       want, "--rules_path", rules])
    assert out.replace(str(got), str(want)) == jout
    for name in ("oovs_found.txt", "utterance_oovs.txt"):
        assert (got / name).read_text() == (want / name).read_text()


def test_model_commands(mono, tmp_path, capsys):
    _tmp, _corpus_dir, model_path, dict_path = mono
    assert cli_main(["model", "inspect", str(model_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == json.loads(jax_run(JCLI.model_inspect_cli, [model_path]))
    assert cli_main(["model", "save", "acoustic", str(model_path),
                     "--name", "mine"]) == 0
    assert cli_main(["model", "save", "acoustic", str(model_path),
                     "--name", "mine"]) == 1
    assert cli_main(["models", "save", "acoustic", str(model_path),
                     "--name", "mine", "--overwrite"]) == 0
    assert cli_main(["model", "add", "dictionary", str(dict_path)]) == 0
    capsys.readouterr()
    assert cli_main(["model", "list"]) == 0
    listed = capsys.readouterr().out
    assert "acoustic:\n  mine\n" in listed
    assert f"dictionary:\n  {dict_path.stem}\n" in listed
    assert cli_main(["model", "download", "acoustic", "english_mfa"]) == 1
    assert "needs the network" in capsys.readouterr().err
    # add_words: new pronunciations of known phones merge; a new phone refuses
    base = tmp_path / "base.dict"
    base.write_text(dict_path.read_text())
    phones = sorted({p for line in base.read_text().splitlines()
                     for p in line.split()[1:]})
    new = tmp_path / "new.dict"
    new.write_text(f"newword\t{' '.join(phones[:2])}\n")
    assert cli_main(["model", "add_words", str(base), str(new)]) == 0
    assert "newword" in base.read_text()
    new.write_text("other\tQQ\n")
    assert cli_main(["model", "add_words", str(base), str(new)]) == 1


def test_version_configure_history(tmp_path, capsys):
    from montreal_forced_aligner_tpu_torch import __version__
    from montreal_forced_aligner_tpu_torch import config as PC

    assert cli_main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__
    assert cli_main(["configure", "--profile", "fast", "--batch_size", "64",
                     "--no_clean"]) == 0
    saved = (tmp_path / "mfa" / "global_config.yaml").read_text()
    assert "fast:" in saved and "batch_size: 64" in saved
    PC._config = None
    assert PC.get_config().profiles["fast"].batch_size == 64
    PC.record_history(["align", "a", "b"], exit_code=0)
    PC.record_history(["train", "c"], exit_code=1)
    capsys.readouterr()
    assert cli_main(["history", "--depth", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].endswith("(exit 1)  train c")


def test_history_store_survives_concurrent_and_broken_writes(tmp_path, monkeypatch):
    """The ranks of one launch record their command at once: each rename
    leaves a whole store, and a store left unreadable starts anew."""
    import threading

    import yaml

    from montreal_forced_aligner_tpu_torch import config as PC

    monkeypatch.setenv("MFA_TPU_TEMP_DIR", str(tmp_path / "store"))
    PC.history_path().parent.mkdir(parents=True)
    PC.history_path().write_text("- command: [align]\nbroken: [\n")
    PC.record_history(["align", "x"])
    assert [e["command"] for e in PC.load_history()] == [["align", "x"]]

    seen, errors, stop = [], [], threading.Event()

    def read():
        while not stop.is_set():
            try:
                seen.append(len(yaml.safe_load(PC.history_path().read_text())))
            except Exception as e:  # a partial store: None, or a YAML error
                errors.append(e)

    reader = threading.Thread(target=read)
    reader.start()
    for i in range(50):
        PC.record_history(["train", str(i)])
    stop.set()
    reader.join()
    assert len(PC.load_history()) == 51 and seen and not errors
    assert not list(PC.history_path().parent.glob("*.tmp"))
