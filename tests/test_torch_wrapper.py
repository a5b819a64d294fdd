"""The port's batch-alignment API (``wrapper.MFA``) against the JAX
package's on the CPU: the same records, read from ``audio_path`` or given as
in-memory ``samples``, through both classes give the same words and phones
(labels and times equal; the per-frame log-likelihood within 1e-3
relative).
"""

import numpy as np
import pytest

from helpers import build_synthetic_corpus, build_synthetic_model, synth_wave


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wrapper")
    model_path, dict_path = build_synthetic_model(tmp)
    corpus_dir, _wave = build_synthetic_corpus(tmp)
    return model_path, dict_path, corpus_dir


def _records(corpus_dir):
    wav = next(corpus_dir.rglob("*.wav"))
    wave = synth_wave()
    return [
        {"speaker_id": "s1", "file_id": "from_path", "text": "ab a",
         "audio_path": str(wav)},
        {"speaker_id": "s2", "file_id": "from_samples", "text": "ab a",
         "samples": wave},
        {"speaker_id": "s2", "file_id": "shifted", "text": "ab a",
         "samples": np.concatenate([np.zeros(1600, np.float32), wave])},
    ]


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["file_id"] == w["file_id"] and g["speaker_id"] == w["speaker_id"]
        assert g["words"] == w["words"] and g["phones"] == w["phones"]
        assert g["words"] and g["phones"]
        assert abs(g["log_likelihood"] - w["log_likelihood"]) <= \
            1e-3 * abs(w["log_likelihood"])


def test_mfa_matches_jax(model):
    from montreal_forced_aligner_tpu.wrapper import MFA as JMFA
    from montreal_forced_aligner_tpu_torch.wrapper import MFA as PMFA

    model_path, dict_path, corpus_dir = model
    records = _records(corpus_dir)
    _check(PMFA(model_path, dict_path, device="cpu").align(records),
           JMFA(model_path, dict_path).align(records))


def test_mfa_config_and_alias(model):
    """An ``AlignerConfig`` passes through, and the short alias
    ``mfa_tpu_torch`` names the same package."""
    import mfa_tpu_torch
    import montreal_forced_aligner_tpu_torch as port
    from montreal_forced_aligner_tpu.align.aligner import AlignerConfig as JCfg
    from montreal_forced_aligner_tpu.wrapper import MFA as JMFA
    from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig
    from montreal_forced_aligner_tpu_torch.wrapper import MFA as PMFA

    assert mfa_tpu_torch.__version__ == port.__version__
    model_path, dict_path, corpus_dir = model
    records = _records(corpus_dir)[1:]
    port_mfa = PMFA(model_path, dict_path, AlignerConfig(batch_size=1),
                    device="cpu")
    assert port_mfa.aligner.config.batch_size == 1
    _check(port_mfa.align(records),
           JMFA(model_path, dict_path, JCfg(batch_size=1)).align(records))
