"""Shared data structures (subset of the reference's ``data.py`` enums and
dataclasses that the alignment path needs; reference ``data.py:2018-2085``)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class WorkflowType(enum.Enum):
    reference = 0
    alignment = 1
    segmentation = 2
    transcription = 3
    phone_transcription = 4
    speech_classification = 5
    acoustic_training = 6
    g2p = 7
    language_model_training = 8
    tokenizer_training = 9
    online_alignment = 10


class ClusterType(enum.Enum):
    """Clustering algorithms for diarization (reference ``data.py:458``)."""

    affinity = "affinity"
    agglomerative = "agglomerative"
    spectral = "spectral"
    dbscan = "dbscan"
    hdbscan = "hdbscan"
    optics = "optics"
    kmeans = "kmeans"
    meanshift = "meanshift"


class DistanceMetric(enum.Enum):
    """Distance metrics for diarization scoring (reference ``data.py:474``)."""

    cosine = "cosine"
    euclidean = "euclidean"
    plda = "plda"


class ManifoldAlgorithm(enum.Enum):
    """Manifold visualization algorithms (reference ``data.py:602``)."""

    tsne = "tsne"
    mds = "mds"
    spectral = "spectral"
    isomap = "isomap"


@dataclass
class CtmInterval:
    """A time-aligned label interval (reference ``data.py:2018``)."""

    begin: float
    end: float
    label: str
    confidence: Optional[float] = None
    phone_id: Optional[int] = None  # position-tagged phone id (internal)

    @property
    def duration(self) -> float:
        return self.end - self.begin


@dataclass
class WordCtmInterval:
    begin: float
    end: float
    label: str
    phones: List[CtmInterval] = field(default_factory=list)


@dataclass
class UtteranceAlignment:
    """Alignment result for one utterance."""

    utterance_id: int
    words: List[WordCtmInterval]
    phones: List[CtmInterval]
    log_likelihood: float
    per_frame_log_likelihood: float


class PhoneSetType(enum.Enum):
    """Phone-set families with automatic base-phone extraction and
    phonological tree questions (reference ``data.py:611``; used for
    triphone tree roots/questions per ``dictionary/mixins.py:224-530``).

    ``base_phone`` strips stress digits (ARPA: AH0/AH1/AH2 -> AH), tone
    digits (PINYIN: ma1..ma5 -> ma) or suprasegmental diacritics (IPA:
    length/tone/stress marks) so variants share a tree root;
    ``extra_questions`` adds phonological-class questions to the
    data-driven clustering."""

    UNKNOWN = "UNKNOWN"
    AUTO = "AUTO"
    IPA = "IPA"
    ARPA = "ARPA"
    PINYIN = "PINYIN"

    def __str__(self) -> str:
        return self.name

    @classmethod
    def detect(cls, phones) -> "PhoneSetType":
        """Pick the most plausible family for a bag of phone labels
        (reference ``regex_detect``/AUTO semantics)."""
        import re

        arpa = re.compile(r"^[A-Z]{1,2}[012]?$")
        pinyin = re.compile(r"^[a-z]{1,6}[12345]$")
        ipa_chars = set("əɚʊɡɤʁɹɔɛʉɒβɲɟʝŋʃɕʰʲɾːˑ˩˨˧˦˥ˌˈθðʒæɑɪʌʏøœɶɯɨ")
        counts = {cls.ARPA: 0, cls.PINYIN: 0, cls.IPA: 0}
        phones = [p for p in phones if p]
        for p in phones:
            if arpa.match(p):
                counts[cls.ARPA] += 1
            if pinyin.match(p):
                counts[cls.PINYIN] += 1
            if any(ch in ipa_chars for ch in p):
                counts[cls.IPA] += 1
        if not phones:
            return cls.UNKNOWN
        best = max(counts, key=lambda k: counts[k])
        return best if counts[best] >= max(1, len(phones) // 2) else cls.UNKNOWN

    def base_phone(self, phone: str) -> str:
        import re

        if self is PhoneSetType.ARPA:
            return re.sub(r"[012]$", "", phone)
        if self is PhoneSetType.PINYIN:
            return re.sub(r"[12345]$", "", phone)
        if self is PhoneSetType.IPA:
            # strip length/stress/tone/aspiration suprasegmentals
            return re.sub(r"[ːˑ˩˨˧˦˥ˌˈʰʱʲʷˀˤ̃̊̚]+", "", phone)
        return phone

    def extra_questions(self):
        """{class-name: set of base phones} phonological questions."""
        if self is PhoneSetType.ARPA:
            # standard Arpabet phonology (US English)
            stops = {"P", "B", "T", "D", "K", "G"}
            affricates = {"CH", "JH"}
            fricatives = {"F", "V", "TH", "DH", "S", "Z", "SH", "ZH", "HH"}
            sibilants = {"S", "Z", "SH", "ZH", "CH", "JH"}
            nasals = {"M", "N", "NG"}
            approximants = {"L", "R", "W", "Y"}
            laterals = {"L"}
            labials = {"P", "B", "M", "F", "V", "W"}
            coronal = {"T", "D", "N", "S", "Z", "TH", "DH", "SH", "ZH", "CH", "JH", "L", "R"}
            dorsal = {"K", "G", "NG", "HH", "W", "Y"}
            voiced_obstruents = {"B", "D", "G", "V", "DH", "Z", "ZH", "JH"}
            voiceless_obstruents = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
            front_vowels = {"IY", "IH", "EY", "EH", "AE"}
            central_vowels = {"AH", "ER", "AX"}
            back_vowels = {"UW", "UH", "OW", "AO", "AA"}
            diphthongs = {"AY", "AW", "OY", "EY", "OW"}
            rounded = {"UW", "UH", "OW", "AO", "OY", "AW", "W"}
            vowels = front_vowels | central_vowels | back_vowels | diphthongs
            return {
                "stops": stops,
                "affricates": affricates,
                "fricatives": fricatives,
                "sibilants": sibilants,
                "nasals": nasals,
                "approximants": approximants,
                "laterals": laterals,
                "labials": labials,
                "coronal": coronal,
                "dorsal": dorsal,
                "voiced_obstruents": voiced_obstruents,
                "voiceless_obstruents": voiceless_obstruents,
                "front_vowels": front_vowels,
                "central_vowels": central_vowels,
                "back_vowels": back_vowels,
                "diphthongs": diphthongs,
                "rounded_vowels": rounded,
                "vowels": vowels,
                "consonants": stops | affricates | fricatives | nasals | approximants,
            }
        if self is PhoneSetType.IPA:
            stops = set("ptʈckqbdɖɟɡɢʔ")
            fricatives = set("fvθðszʃʒʂʐɕʑçʝxɣχʁħʕhɦɸβ")
            nasals = set("mɱnɳɲŋɴ")
            approximants = set("ʋɹɻjɰlɭʎʟwɥ")
            trills_taps = set("ʙrʀɾɽ")
            front_vowels = set("iyɪʏeøɛœæaɶ")
            central_vowels = set("ɨʉɘɵəɚɜɝɞɐ")
            back_vowels = set("ɯuʊɤoʌɔɑɒ")
            rounded = set("yʏøœɶʉɵuʊoɔɒ")
            vowels = front_vowels | central_vowels | back_vowels
            return {
                "stops": stops,
                "fricatives": fricatives,
                "nasals": nasals,
                "approximants": approximants,
                "trills_taps": trills_taps,
                "front_vowels": front_vowels,
                "central_vowels": central_vowels,
                "back_vowels": back_vowels,
                "rounded_vowels": rounded,
                "vowels": vowels,
                "consonants": stops | fricatives | nasals | approximants | trills_taps,
            }
        if self is PhoneSetType.PINYIN:
            # group by tone across all syllables; initials vs finals
            return {}
        return {}

    def tone_questions(self, phones):
        """For tonal sets: {tone: set of full phone labels with that tone}."""
        import re

        if self is not PhoneSetType.PINYIN:
            return {}
        out = {}
        for p in phones:
            m = re.search(r"([12345])$", p)
            if m:
                out.setdefault(f"tone_{m.group(1)}", set()).add(p)
        return {k: v for k, v in out.items() if len(v) > 1}


class PhoneType(enum.Enum):
    """Phone categories (reference ``data.py:360``)."""

    non_silence = 1
    silence = 2
    oov = 3
    disambiguation = 4
    extra = 5


class WordType(enum.Enum):
    """Word categories (reference ``data.py:426``)."""

    speech = 1
    clitic = 2
    silence = 3
    oov = 4
    bracketed = 5
    laughter = 6
    cutoff = 7
    music = 8
    noise = 9
    interjection = 10

    @classmethod
    def classify(cls, word: str, lexicon=None) -> "WordType":
        """Classify a (normalized) word label the way the reference's
        dictionary setup tags special words
        (``dictionary/mixins.py:91-194``, ``multispeaker.py:889``)."""
        ow = getattr(lexicon, "oov_word", "<unk>")
        sw = getattr(lexicon, "silence_word", "<eps>")
        lw = getattr(lexicon, "laughter_word", "[laughter]")
        bw = getattr(lexicon, "bracketed_word", "[bracketed]")
        cw = getattr(lexicon, "cutoff_word", "<cutoff>")
        if word == sw:
            return cls.silence
        if word == ow:
            return cls.oov
        if word == lw or word.strip("[]{}<>") == "laughter":
            return cls.laughter
        if word == cw or word.startswith(cw[:-1] + "-"):
            return cls.cutoff
        if word.startswith(("[", "{", "<")) and word.endswith(("]", "}", ">")):
            return cls.bracketed
        if word.startswith("'") or word.endswith("'"):
            return cls.clitic
        return cls.speech


class Language(enum.Enum):
    """Language hints for tokenizers and neural transcribers (reference
    ``data.py:481``; the reference routes spacy/sudachipy/mecab/pythainlp
    pipelines and whisper decoding through this)."""

    unknown = "unknown"
    multilingual = "multilingual"
    arabic = "arabic"
    bulgarian = "bulgarian"
    catalan = "catalan"
    chinese = "chinese"
    croatian = "croatian"
    czech = "czech"
    danish = "danish"
    dutch = "dutch"
    english = "english"
    finnish = "finnish"
    french = "french"
    german = "german"
    greek = "greek"
    hausa = "hausa"
    hebrew = "hebrew"
    hindi = "hindi"
    hungarian = "hungarian"
    icelandic = "icelandic"
    indonesian = "indonesian"
    italian = "italian"
    japanese = "japanese"
    korean = "korean"
    lithuanian = "lithuanian"
    macedonian = "macedonian"
    maltese = "maltese"
    norwegian = "norwegian"
    persian = "persian"
    polish = "polish"
    portuguese = "portuguese"
    romanian = "romanian"
    russian = "russian"
    serbian = "serbian"
    slovak = "slovak"
    slovenian = "slovenian"
    spanish = "spanish"
    swahili = "swahili"
    swedish = "swedish"
    tamil = "tamil"
    thai = "thai"
    turkish = "turkish"
    ukrainian = "ukrainian"
    urdu = "urdu"
    vietnamese = "vietnamese"

    @property
    def iso_code(self) -> str:
        codes = {
            "arabic": "ar", "bulgarian": "bg", "catalan": "ca",
            "chinese": "zh", "croatian": "hr", "czech": "cs",
            "danish": "da", "dutch": "nl", "english": "en",
            "finnish": "fi", "french": "fr", "german": "de",
            "greek": "el", "hausa": "ha", "hebrew": "he", "hindi": "hi",
            "hungarian": "hu", "icelandic": "is", "indonesian": "id",
            "italian": "it", "japanese": "ja", "korean": "ko",
            "lithuanian": "lt", "macedonian": "mk", "maltese": "mt",
            "norwegian": "no", "persian": "fa", "polish": "pl",
            "portuguese": "pt", "romanian": "ro", "russian": "ru",
            "serbian": "sr", "slovak": "sk", "slovenian": "sl",
            "spanish": "es", "swahili": "sw", "swedish": "sv",
            "tamil": "ta", "thai": "th", "turkish": "tr",
            "ukrainian": "uk", "urdu": "ur", "vietnamese": "vi",
        }
        return codes.get(self.value, self.value)
