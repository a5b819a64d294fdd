"""The port's native graph compile and graph worker pool, on the CPU.

* ``native/graph_assembly.cc`` through ``graph/native_compile.py``:
  monophone graphs bit-identical to the port's Python compiler and to the
  JAX package's ``AlignmentGraphCompiler.compile``, on the cases of the JAX
  package's own native-graph test. ``g++`` builds the library here, so
  nothing skips; a source that does not build raises.
* ``graph/parallel.py``: triphone graphs from the worker pools identical to
  serial compilation; a ``CompiledGraph`` pickles without tensors.
* Routing: the aligner takes the native core for a monophone tree and the
  pool for a triphone tree with ``num_graph_workers > 0``, as does the
  training pipeline, with the same alignments and graphs as serial.
"""

import pickle

import numpy as np
import pytest

import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.graph.native_compile as PN
from montreal_forced_aligner_tpu.align.aligner import (
    AlignerConfig as JConfig,
    PretrainedAligner as JAligner,
)
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.graph.parallel import (
    ParallelGraphCompiler,
    SharedGraphCompilerPool,
)
from montreal_forced_aligner_tpu_torch.ops import cuda_build
from montreal_forced_aligner_tpu_torch.training.base import TrainingPipeline

from helpers import build_sat_scale_model, build_synthetic_corpus, build_synthetic_model

FIELDS = ("state_pdf", "state_phone", "state_word", "state_hmm_pos",
          "state_tstate", "state_instance", "in_src", "in_weight", "in_tid",
          "start", "final", "final_tid")


def assert_identical(a, b, label):
    assert a.words == b.words, label
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape and x.dtype == y.dtype, f"{label}:{k}"
        np.testing.assert_array_equal(x, y, err_msg=f"{label}:{k}")


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_graph")
    corpus_dir, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    port = PA.PretrainedAligner(model_path, dict_path,
                                PA.AlignerConfig(batch_size=4), device="cpu")
    jax = JAligner(model_path, dict_path, JConfig(batch_size=4))
    return corpus_dir, model_path, dict_path, port, jax


@pytest.fixture(scope="module")
def tri(tmp_path_factory):
    """A reduced SAT-scale (triphone) model and 12 utterances."""
    import chip_smoke

    tmp = tmp_path_factory.mktemp("pool_graph")
    model_path, dict_path = build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 12, min_s=1.5, max_s=3.0,
                                            num_speakers=2)
    return model_path, dict_path, corpus_dir


def _cases(lexicon):
    words = sorted(w for w in lexicon.words if w.isalpha())
    rng = np.random.RandomState(7)
    return [
        [],  # empty transcript -> single silence
        [words[0]],
        [words[0], words[0]],  # consecutive repeat
        list(rng.choice(words, 5)),
        list(rng.choice(words, 25)),
        ["definitelynotinthedictionary", words[0]],  # OOV -> <unk>/spn
    ]


def test_native_matches_python_and_jax(mono):
    _c, _m, _d, port, jax = mono
    cases = _cases(port.lexicon)
    native = PN.compile_batch_native(port.compiler, cases)
    assert native is not None and len(native) == len(cases)
    for tokens, ng in zip(cases, native):
        label = " ".join(tokens) or "<empty>"
        assert_identical(ng, port.compiler.compile(list(tokens)), label)
        assert_identical(ng, jax.compiler.compile(list(tokens)), label + " (jax)")


def test_native_items_grouping(mono):
    _c, _m, _d, port, _jax = mono
    words = sorted(w for w in port.lexicon.words if w.isalpha())
    items = [("default", [words[0], words[1]]), ("default", [words[1]])]
    out = PN.compile_items_native({"default": port.compiler}, items)
    for (_key, tokens), ng in zip(items, out):
        assert_identical(ng, port.compiler.compile(list(tokens)), " ".join(tokens))


def test_native_skips_context_dependent_trees(tri):
    model_path, dict_path, _corpus = tri
    port = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    assert port.compiler.tree.N == 3
    assert PN.compile_batch_native(port.compiler, [["a"]]) is None
    key = port.default_dictionary_key
    assert PN.compile_items_native(port.compilers, [(key, ["a"])]) is None


def test_native_build_failure_raises(mono, monkeypatch, tmp_path):
    _c, _m, _d, port, _jax = mono
    bad = tmp_path / "graph_assembly.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(cuda_build.SOURCES, "graph_assembly",
                        cuda_build.Source(bad, "g++", ["-shared", "-fPIC"]))
    monkeypatch.delitem(cuda_build._libs, "graph_assembly", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PN.compile_batch_native(port.compiler, [["ab"]])


def test_aligner_takes_the_native_core_for_monophones(mono, monkeypatch):
    corpus_dir, _m, _d, port, jax = mono
    calls = []
    real = PN.compile_items_native

    def spy(compilers, items, num_threads=None):
        out = real(compilers, items, num_threads)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(PN, "compile_items_native", spy)
    got = port.align_corpus(PCorpus.load(corpus_dir))
    assert calls == [True]
    from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus

    want = jax.align_corpus(JCorpus.load(corpus_dir))
    for k in want:
        assert [(p.label, p.begin, p.end) for p in got[k].phones] == [
            (p.label, p.begin, p.end) for p in want[k].phones]


class _NoTorch(pickle.Unpickler):
    def find_class(self, module, name):
        assert module.split(".")[0] != "torch", (module, name)
        return super().find_class(module, name)


def test_compiled_graph_pickles_without_tensors(mono):
    import io

    _c, _m, _d, port, _jax = mono
    g = PN.compile_batch_native(port.compiler, [[w for w in port.lexicon.words][:2]])[0]
    back = _NoTorch(io.BytesIO(pickle.dumps(g))).load()
    assert_identical(back, g, "pickled")


def _tokens(aligner, corpus_dir):
    corpus = PCorpus.load(corpus_dir)
    return [aligner.tokenizer.tokenize(u.text) for u in corpus.utterances]


def test_pools_match_serial(tri):
    model_path, dict_path, corpus_dir = tri
    port = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    toks = _tokens(port, corpus_dir)
    serial = [port.compiler.compile(t) for t in toks]
    items = [(port.default_dictionary_key, t) for t in toks]
    pool = ParallelGraphCompiler(port.compilers, 2)
    try:
        for s, g in zip(serial, pool.compile_all(items)):
            assert_identical(g, s, "ParallelGraphCompiler")
    finally:
        pool.close(wait=True)
    shared = SharedGraphCompilerPool(2)
    try:
        for _ in range(2):  # a second table version reuses the workers
            out = shared.compile_all([("", t) for t in toks], {"": port.compiler})
            for s, g in zip(serial, out):
                assert_identical(g, s, "SharedGraphCompilerPool")
    finally:
        shared.close(wait=True)


def test_graph_workers_in_align_and_training(tri):
    model_path, dict_path, corpus_dir = tri
    results = {}
    for workers in (0, 2):
        cfg = PA.AlignerConfig(batch_size=4, num_graph_workers=workers,
                               uses_speaker_adaptation=False)
        al = PA.PretrainedAligner(model_path, dict_path, cfg, device="cpu")
        results[workers] = al.align_corpus(PCorpus.load(corpus_dir))
        if workers:
            assert al._graph_pool_obj is not None
            al._graph_pool_obj.close(wait=True)
    for k, want in results[0].items():
        got = results[2][k]
        assert [(p.label, p.begin, p.end) for p in got.phones] == [
            (p.label, p.begin, p.end) for p in want.phones]
    port = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    garrs = {}
    for workers in (0, 2):
        pipe = TrainingPipeline(PCorpus.load(corpus_dir), port.lexicon, batch_size=4,
                                lda_mat=port.model.lda_mat, uses_deltas=False,
                                num_graph_workers=workers, device="cpu")
        pipe.prepare_features()
        pipe.compile_graphs(port.compiler)
        garrs[workers] = [fb.garrs for fb in pipe.batches]
        if workers:
            assert pipe._graph_pool is not None
            pipe._graph_pool.close(wait=True)
    for a, b in zip(garrs[0], garrs[2]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
