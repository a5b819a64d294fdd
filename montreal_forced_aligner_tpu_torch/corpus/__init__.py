from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus, Utterance

__all__ = ["Corpus", "Utterance"]
