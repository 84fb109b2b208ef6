"""Built-in rule-based English G2P producing IPA.

A dependency-free fallback phonemizer so phoneme-mode models work on hosts
without espeak/gruut. Quality is below espeak-ng —
it exists so training/inference pipelines don't silently degrade to graphemes.
A lexicon of frequent irregular words backs a classic longest-match
letter-to-sound ruleset. All output symbols are drawn from the default
`IPAPhonemes` vocabulary (`tpu_tts_torch/text/characters.py`). A copy of
`tpu_tts/text/phonemizers/en_rules.py`: the same words give the same IPA.
"""

from typing import Dict, List

from tpu_tts_torch.text.phonemizers.base import BasePhonemizer
from tpu_tts_torch.text.punctuation import Punctuation

# frequent irregular words (IPA, GenAm)
_LEXICON: Dict[str, str] = {
    "a": "ə", "an": "æn", "the": "ðə", "of": "ʌv", "to": "tuː", "and": "ænd",
    "i": "aɪ", "you": "juː", "he": "hiː", "she": "ʃiː", "we": "wiː", "they": "ðeɪ",
    "it": "ɪt", "is": "ɪz", "are": "ɑːɹ", "was": "wʌz", "were": "wɜːɹ".replace("ɜ", "ɚ"),
    "be": "biː", "been": "bɪn", "being": "biːɪŋ", "have": "hæv", "has": "hæz",
    "had": "hæd", "do": "duː", "does": "dʌz", "did": "dɪd", "will": "wɪl",
    "would": "wʊd", "could": "kʊd", "should": "ʃʊd", "can": "kæn", "cannot": "kænɑt",
    "one": "wʌn", "two": "tuː", "four": "fɔːɹ", "eight": "eɪt", "once": "wʌns",
    "what": "wʌt", "who": "huː", "whose": "huːz", "where": "wɛɹ", "there": "ðɛɹ",
    "their": "ðɛɹ", "here": "hɪɹ", "why": "waɪ", "how": "haʊ", "when": "wɛn",
    "which": "wɪtʃ", "this": "ðɪs", "that": "ðæt", "these": "ðiːz", "those": "ðoʊz",
    "with": "wɪθ", "from": "fɹʌm", "for": "fɔːɹ", "your": "jɔːɹ", "my": "maɪ",
    "me": "miː", "his": "hɪz", "her": "hɚ", "our": "aʊɚ", "us": "ʌs",
    "said": "sɛd", "says": "sɛz", "say": "seɪ", "not": "nɑt", "no": "noʊ",
    "yes": "jɛs", "all": "ɔːl", "any": "ɛni", "many": "mɛni", "some": "sʌm",
    "come": "kʌm", "comes": "kʌmz", "go": "ɡoʊ", "goes": "ɡoʊz", "gone": "ɡɔːn",
    "good": "ɡʊd", "great": "ɡɹeɪt", "people": "piːpəl", "water": "wɔːtɚ",
    "very": "vɛɹi", "only": "oʊnli", "other": "ʌðɚ", "were'nt": "wɚnt",
    "word": "wɚd", "words": "wɚdz", "world": "wɚld", "work": "wɚk",
    "one's": "wʌnz", "done": "dʌn", "none": "nʌn", "give": "ɡɪv", "live": "lɪv",
    "love": "lʌv", "move": "muːv", "above": "əbʌv", "again": "əɡɛn",
    "against": "əɡɛnst", "eye": "aɪ", "eyes": "aɪz", "heart": "hɑːɹt",
    "earth": "ɚθ", "early": "ɚli", "learn": "lɚn", "heard": "hɚd",
    "because": "bɪkɔːz", "before": "bɪfɔːɹ", "through": "θɹuː", "though": "ðoʊ",
    "thought": "θɔːt", "enough": "ɪnʌf", "rough": "ɹʌf", "tough": "tʌf",
    "laugh": "læf", "might": "maɪt", "night": "naɪt", "light": "laɪt",
    "right": "ɹaɪt", "high": "haɪ", "sign": "saɪn", "island": "aɪlənd",
    "hour": "aʊɚ", "honest": "ɑnɪst", "honor": "ɑnɚ", "ghost": "ɡoʊst",
    "school": "skuːl", "choir": "kwaɪɚ", "stomach": "stʌmək", "machine": "məʃiːn",
    "women": "wɪmɪn", "woman": "wʊmən", "busy": "bɪzi", "business": "bɪznəs",
    "pretty": "pɹɪti", "friend": "fɹɛnd", "beautiful": "bjuːtɪfəl",
    "speech": "spiːtʃ", "language": "læŋɡwɪdʒ", "voice": "vɔɪs",
    "says'nt": "sɛz", "mr": "mɪstɚ", "mrs": "mɪsɪz", "dr": "dɑktɚ",
    "synthesis": "sɪnθəsɪs", "text": "tɛkst", "example": "ɪɡzæmpəl",
}

# ordered longest-match grapheme → IPA rules; "$" = word end, "^" = word start
_RULES: List = [
    ("tion", "ʃən"), ("sion", "ʒən"), ("ought", "ɔːt"), ("aught", "ɔːt"),
    ("igh", "aɪ"), ("eigh", "eɪ"), ("ough$", "oʊ"), ("tch", "tʃ"),
    ("sch", "sk"), ("dge", "dʒ"), ("ing$", "ɪŋ"), ("ck", "k"),
    ("wh", "w"), ("ph", "f"), ("gh", "ɡ"), ("ch", "tʃ"), ("sh", "ʃ"),
    ("th", "θ"), ("ng", "ŋ"), ("qu", "kw"), ("wr", "ɹ"), ("kn", "n"),
    ("gn$", "n"), ("mb$", "m"), ("oo", "uː"), ("ee", "iː"), ("ea", "iː"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("ey$", "i"), ("oa", "oʊ"), ("ou", "aʊ"),
    ("ow$", "oʊ"), ("ow", "aʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("au", "ɔː"),
    ("aw", "ɔː"), ("ew", "uː"), ("ie$", "aɪ"), ("ie", "iː"), ("ue", "uː"),
    ("ar", "ɑːɹ"), ("er$", "ɚ"), ("er", "ɚ"), ("ir", "ɚ"), ("ur", "ɚ"),
    ("or", "ɔːɹ"), ("ya", "jə"), ("a", "æ"), ("e$", ""), ("e", "ɛ"),
    ("i", "ɪ"), ("o", "ɑ"), ("u", "ʌ"), ("y$", "i"), ("y", "ɪ"),
    ("b", "b"), ("c", "k"), ("d", "d"), ("f", "f"), ("g", "ɡ"), ("h", "h"),
    ("j", "dʒ"), ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("p", "p"),
    ("r", "ɹ"), ("s", "s"), ("t", "t"), ("v", "v"), ("w", "w"), ("x", "ks"),
    ("z", "z"), ("'", ""),
]

# soft-c / soft-g before front vowels
_FRONT = "eiy"


def _word_to_ipa(word: str) -> str:
    word = word.lower()
    if word in _LEXICON:
        return _LEXICON[word]
    # simple plural/past stripping back to lexicon
    for suffix, tail in (("s", "z"), ("ed", "d"), ("ing", "ɪŋ")):
        if word.endswith(suffix) and word[: -len(suffix)] in _LEXICON:
            return _LEXICON[word[: -len(suffix)]] + tail
    out = []
    i = 0
    n = len(word)
    while i < n:
        matched = False
        for pat, rep in _RULES:
            end_anchor = pat.endswith("$")
            core = pat[:-1] if end_anchor else pat
            j = i + len(core)
            if word[i:j] == core and (not end_anchor or j == n):
                # soft c/g
                if core == "c" and j < n and word[j] in _FRONT:
                    rep = "s"
                elif core == "g" and j < n and word[j] in _FRONT:
                    rep = "dʒ"
                out.append(rep)
                i = j
                matched = True
                break
        if not matched:
            i += 1  # unknown char: drop
    return "".join(out)


class EnglishRules(BasePhonemizer):
    """Rule-based English G2P (no external binaries)."""

    def __init__(self, language="en", punctuations=Punctuation.default_puncs(), keep_puncs=True):
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "en_rules"

    @classmethod
    def is_available(cls) -> bool:
        return True

    @classmethod
    def version(cls) -> str:
        return "0.1"

    @staticmethod
    def supported_languages() -> List[str]:
        return ["en", "en-us", "en-gb"]

    def _phonemize(self, text: str, separator: str) -> str:
        # words stay separated by a space (part of the punctuations/vocab);
        # `separator` (if any) goes between phonemes within a word.
        sep = separator or ""
        return " ".join(sep.join(_word_to_ipa(w)) if sep else _word_to_ipa(w) for w in text.split())
