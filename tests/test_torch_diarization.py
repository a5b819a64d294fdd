"""The port's diarization (``diarization/*``, ``diarize_speakers``) against
the JAX package's, on the CPU.

* Every ``ClusterType`` on three Gaussian blobs: labels identical to the
  JAX package's, and the JAX test's purity bar.
* ``SpeakerDiarizer`` cluster and classify from one archive, each package
  through its own features and extraction: identical labels.
* The CLI: the port's ``train_ivector`` writes an archive; the port's and
  the JAX package's ``diarize_speakers`` load it, with ``--classify``,
  ``--metric plda``, ``--evaluate`` and each ``--output_format``: the same
  ``utt2spk.tsv``, ``parameters.yaml`` and exported transcripts, byte for
  byte. ``--visualize`` writes the plot where sklearn is present.
* The JAX package's ``relabel_corpus`` pairs batch-order labels with the
  corpus order; the port's takes the batches' ``order``.
* ``speechbrain`` x-vectors through the port's stand-in package: the JAX
  command's utt2spk; the missing-package and checkpoint errors.
"""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import montreal_forced_aligner_tpu.cli as JCLI
from montreal_forced_aligner_tpu.diarization import clustering as JC
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.diarization import clustering as PC

from test_ivector import SR, make_speaker_wave
from test_torch_ivector import write_speaker_corpus


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    """The JAX CLI's history and temporary stores in this test's directory."""
    monkeypatch.setenv("MFA_TPU_MODEL_ROOT", str(tmp_path / "models"))
    monkeypatch.setenv("MFA_TPU_TEMP_DIR", str(tmp_path / "mfa"))


BLOB_METHODS = [
    ("kmeans", dict(num_clusters=3)),
    ("spectral", dict(num_clusters=3)),
    ("agglomerative", dict(num_clusters=3)),
    ("dbscan", dict(distance_threshold=1.5, min_cluster_size=5)),
    ("optics", dict(distance_threshold=1.5, min_cluster_size=5)),
    ("hdbscan", dict(distance_threshold=1.5, min_cluster_size=5)),
    ("meanshift", dict()),
    ("affinity", dict()),
]


@pytest.mark.parametrize("method,kwargs", BLOB_METHODS, ids=[m for m, _ in BLOB_METHODS])
def test_every_cluster_type_matches_jax(method, kwargs):
    rng = np.random.RandomState(7)
    centers = np.array([[0.0, 0.0], [8.0, 0.0], [0.0, 8.0]])
    x = np.concatenate([c + 0.4 * rng.randn(20, 2) for c in centers], axis=0)
    truth = np.repeat(np.arange(3), 20)
    got = PC.cluster_matrix(x, method, metric="euclidean", **kwargs)
    want = JC.cluster_matrix(x, method, metric="euclidean", **kwargs)
    np.testing.assert_array_equal(got, want)
    assert np.unique(got[got >= 0]).shape[0] >= 3
    assert PC.cluster_purity(truth, got) >= 0.9
    assert PC.adjusted_rand_index(truth, got) == JC.adjusted_rand_index(truth, want)
    D = PC.euclidean_distance_matrix(x)
    assert PC.calculate_distance_threshold(D, min_samples=5) == \
        JC.calculate_distance_threshold(JC.euclidean_distance_matrix(x), min_samples=5)
    assert PC.silhouette_score(D, truth) == JC.silhouette_score(D, truth)


@pytest.fixture(scope="module")
def diar_corpus(tmp_path_factory):
    """Two tone speakers: three whole-file utterances each, and one
    conversation file whose TextGrid holds two utterances of each (so the
    export writes relabelled tiers); and an archive trained by the port's
    CLI (8 Gaussians, 4 dimensions, PLDA)."""
    from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    tmp = tmp_path_factory.mktemp("diar")
    root = write_speaker_corpus(tmp / "corpus", n_utts=3, seed=11, text="hello there")
    rng = np.random.RandomState(12)
    pieces, tiers, t = [], {"spk0": [], "spk1": []}, 0.0
    for i in range(4):
        spk = i % 2
        w = make_speaker_wave(rng, spk, 4.0)
        pieces.append(w)
        tiers[f"spk{spk}"].append(Interval(t, t + len(w) / SR, f"turn {i}"))
        t += len(w) / SR
    (root / "conv").mkdir()
    write_wave(root / "conv" / "talk.wav", np.concatenate(pieces), SR)
    TextGrid(xmin=0.0, xmax=t, tiers=tiers).write(root / "conv" / "talk.TextGrid")
    model = tmp / "ivec.npz"
    rc = cli_main(["train_ivector", str(root), str(model), "--num_gauss", "8",
                   "--ivector_dim", "4", "--num_iterations", "3",
                   "--batch_size", "4", "--device", "cpu", "-j", "2"])
    assert rc == 0
    return root, model


def test_train_ivector_bundles_plda(diar_corpus, capsys):
    import montreal_forced_aligner_tpu.ivector.extractor as JE

    _root, model = diar_corpus
    ex = JE.IvectorExtractor.load(model)  # the JAX package reads it
    assert ex.plda is not None and ex.T.shape == (ex.ubm.num_gauss, 39, 4)
    assert 4 <= ex.ubm.num_gauss <= 8


def test_speaker_diarizer_matches_jax(diar_corpus):
    import montreal_forced_aligner_tpu.diarization.speaker_diarizer as JD
    import montreal_forced_aligner_tpu.ivector.extractor as JE
    import montreal_forced_aligner_tpu.ivector.pipeline as JP
    import montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer as PD
    import montreal_forced_aligner_tpu_torch.ivector.extractor as PE
    import montreal_forced_aligner_tpu_torch.ivector.pipeline as PP
    from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus

    root, model = diar_corpus
    jc = JCorpus.load(root, require_transcripts=False)
    pc = PCorpus.load(root, require_transcripts=False)
    jb, jorder = JP.corpus_feature_batches(jc, batch_size=4)
    pb, porder = PP.corpus_feature_batches(pc, batch_size=4, device="cpu")
    assert list(map(int, porder)) == list(map(int, jorder))
    jex, pex = JE.IvectorExtractor.load(model), PE.IvectorExtractor.load(model)
    for metric in ("cosine", "plda"):
        jd = JD.SpeakerDiarizer(jex, plda=jex.plda, metric=metric)
        pd = PD.SpeakerDiarizer(pex, plda=pex.plda, metric=metric, device="cpu")
        for method in ("agglomerative", "kmeans"):
            got = pd.cluster_utterances(pb, num_speakers=2, method=method)
            want = jd.cluster_utterances(jb, num_speakers=2, method=method)
            np.testing.assert_array_equal(got.labels, want.labels)
            cos = (got.ivectors * want.ivectors).sum(1) / (
                np.linalg.norm(got.ivectors, axis=1)
                * np.linalg.norm(want.ivectors, axis=1))
            assert cos.min() >= 0.999
        enrolled = {s: got.ivectors[[p for p, u in enumerate(porder)
                                     if pc.utterances[u].speaker == s]].mean(0)
                    for s in pc.speakers}
        assert pd.classify_speakers(pb, enrolled) == jd.classify_speakers(jb, enrolled)


def test_relabel_corpus_follows_the_batch_order(diar_corpus):
    """Labels come in batch order (utterances sorted by length). The port's
    ``relabel_corpus`` gives each label to ``corpus.utterances[order[i]]``;
    the JAX package's gives label i to ``corpus.utterances[i]``, which is
    another utterance whenever the sort moved it."""
    import montreal_forced_aligner_tpu.diarization.speaker_diarizer as JD
    import montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer as PD
    from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
    from montreal_forced_aligner_tpu_torch.ivector.pipeline import corpus_feature_batches

    root, _model = diar_corpus
    pc = PCorpus.load(root, require_transcripts=False)
    _batches, order = corpus_feature_batches(pc, batch_size=4, device="cpu")
    assert list(order) != list(range(pc.num_utterances))
    labels = np.arange(pc.num_utterances)  # label i for batch row i
    PD.SpeakerDiarizer.relabel_corpus(None, pc, labels, order)
    for pos, ui in enumerate(order):
        assert pc.utterances[ui].speaker == f"speaker{pos}"
    jc = JCorpus.load(root, require_transcripts=False)
    JD.SpeakerDiarizer.relabel_corpus(None, jc, labels)
    wrong = [pos for pos, ui in enumerate(order)
             if jc.utterances[ui].speaker != f"speaker{pos}"]
    assert wrong  # the JAX package keeps the fault


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


DIARIZE_CASES = {
    "cluster-evaluate-long": ["--expected_num_speakers", "2", "--evaluate"],
    "plda-kmeans-short": ["--metric", "plda", "--cluster_type", "kmeans",
                          "--expected_num_speakers", "2",
                          "--output_format", "short_textgrid"],
    "classify-json": ["--classify", "--output_format", "json"],
    "threshold-csv": ["--distance_threshold", "0.5", "--output_format", "csv"],
}


@pytest.mark.parametrize("case", list(DIARIZE_CASES))
def test_diarize_cli_matches_jax(diar_corpus, tmp_path, capsys, case):
    root, model = diar_corpus
    extra = DIARIZE_CASES[case] + ["--batch_size", "4"]
    rc = cli_main(["diarize_speakers", str(root), str(model),
                   str(tmp_path / "port"), "--device", "cpu", "-j", "2"] + extra)
    assert rc == 0
    out = capsys.readouterr().out
    r = CliRunner().invoke(JCLI.cli, ["diarize_speakers", str(root), str(model),
                                      str(tmp_path / "jax")] + extra,
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    fmt = (extra[extra.index("--output_format") + 1] if "--output_format" in extra
           else "long_textgrid")
    ext = ".TextGrid" if fmt.endswith("textgrid") else f".{fmt}"
    assert f"talk{ext}" in got and "utt2spk.tsv" in got
    assert len([n for n in got if n.endswith(".lab")]) == 6
    if "--evaluate" in extra:
        line = [l for l in out.splitlines() if "purity" in l][0]
        assert line in r.output
    if "--classify" in extra:
        assert "reassigned" in out


def test_diarize_config_path_and_visualize(diar_corpus, tmp_path, capsys):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    import yaml

    root, model = diar_corpus
    cfg = tmp_path / "diar.yaml"
    cfg.write_text("expected_num_speakers: 2\nmetric: plda\nbatch_size: 4\n")
    out = tmp_path / "port"
    rc = cli_main(["diarize_speakers", str(root), str(model), str(out),
                   "--device", "cpu", "--config_path", str(cfg), "--visualize",
                   "--manifold_algorithm", "mds"])
    assert rc == 0
    assert "cluster plot" in capsys.readouterr().out
    assert (out / "cluster_plot.png").stat().st_size > 1000
    params = yaml.safe_load((out / "parameters.yaml").read_text())
    assert params["expected_num_speakers"] == 2 and params["metric"] == "plda"


def test_diarize_speechbrain_and_default_device_raise(diar_corpus, tmp_path):
    """``diarize_speakers speechbrain`` raises the JAX package's error
    without the speechbrain package, and a missing checkpoint's; through
    the port's stand-in it writes the JAX command's utt2spk; the default
    device raises without a card."""
    import torch_mock_speechbrain

    root, model = diar_corpus
    with pytest.raises(RuntimeError, match="speechbrain is not available; x-vector"):
        cli_main(["diarize_speakers", str(root), "speechbrain", str(tmp_path / "o"),
                  "--xvector_model_path", str(tmp_path), "--device", "cpu"])
    ckpt = tmp_path / "sb_spk"
    ckpt.mkdir()
    torch_mock_speechbrain.install()
    try:
        with pytest.raises(FileNotFoundError, match="no local SpeechBrain speaker"):
            cli_main(["diarize_speakers", str(root), "speechbrain", str(tmp_path / "o"),
                      "--xvector_model_path", str(tmp_path / "missing"),
                      "--device", "cpu"])
        opts = ["--xvector_model_path", str(ckpt), "--expected_num_speakers", "2"]
        assert cli_main(["diarize_speakers", str(root), "speechbrain",
                         str(tmp_path / "port"), "--device", "cpu"] + opts) == 0
        r = CliRunner().invoke(JCLI.cli, ["diarize_speakers", str(root), "speechbrain",
                                          str(tmp_path / "jax")] + opts,
                               catch_exceptions=False)
        assert r.exit_code == 0, r.output
        got = (tmp_path / "port" / "utt2spk.tsv").read_text()
        assert got == (tmp_path / "jax" / "utt2spk.tsv").read_text()
        assert len(set(line.split("\t")[3] for line in got.splitlines())) == 2
    finally:
        torch_mock_speechbrain.uninstall()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["diarize_speakers", str(root), "speechbrain", str(tmp_path / "o"),
                  "--xvector_model_path", str(ckpt)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["diarize_speakers", str(root), str(model), str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["train_ivector", str(root), str(tmp_path / "m.npz")])