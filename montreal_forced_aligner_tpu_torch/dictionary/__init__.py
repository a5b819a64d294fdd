from montreal_forced_aligner_tpu_torch.dictionary.lexicon import (
    Lexicon,
    Pronunciation,
    parse_dictionary_file,
)
from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import SimpleTokenizer

__all__ = ["Lexicon", "Pronunciation", "parse_dictionary_file", "SimpleTokenizer"]
