"""Pluggable text cleaners (ref Coqui TTS `TTS/tts/utils/text/cleaners.py`).

Same registry surface (functions looked up by name from the config's
``text_cleaner`` field). `convert_to_ascii` uses a unicodedata-based
transliteration instead of the `anyascii` package. The port carries the
English and language-neutral cleaners; French and Mandarin come with the
phonemizers (ROADMAP).
"""

import re
import unicodedata

from tpu_tts_torch.text.english.abbreviations import abbreviations_en
from tpu_tts_torch.text.english.number_norm import normalize_numbers as en_normalize_numbers
from tpu_tts_torch.text.english.time_norm import expand_time_english

_whitespace_re = re.compile(r"\s+")


def expand_abbreviations(text: str, lang: str = "en") -> str:
    if lang != "en":  # other languages' tables come with their phonemizers
        return text
    for regex, replacement in abbreviations_en:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text).strip()


def convert_to_ascii(text: str) -> str:
    """Best-effort ASCII transliteration via Unicode decomposition."""
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def remove_aux_symbols(text: str) -> str:
    return re.sub(r"[\<\>\(\)\[\]\"]+", "", text)


def replace_symbols(text: str, lang: str = "en") -> str:
    text = text.replace(";", ",")
    text = text.replace("-", " ") if lang != "ca" else text.replace("-", "")
    text = text.replace(":", ",")
    if lang == "en":
        text = text.replace("&", " and ")
    elif lang == "fr":
        text = text.replace("&", " et ")
    elif lang == "pt":
        text = text.replace("&", " e ")
    elif lang == "ca":
        text = text.replace("&", " i ")
        text = text.replace("'", "")
    return text


def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def basic_german_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def basic_turkish_cleaners(text: str) -> str:
    text = text.replace("I", "ı")
    return collapse_whitespace(lowercase(text))


def english_cleaners(text: str) -> str:
    """Full English pipeline: time, numbers, abbreviations, symbols."""
    text = lowercase(text)
    text = expand_time_english(text)
    text = en_normalize_numbers(text)
    text = expand_abbreviations(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    text = collapse_whitespace(text)
    return text


def phoneme_cleaners(text: str) -> str:
    """Pipeline preceding phonemization: numbers + abbreviations, keep case."""
    text = en_normalize_numbers(text)
    text = expand_abbreviations(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    text = collapse_whitespace(text)
    return text


def portuguese_cleaners(text: str) -> str:
    text = lowercase(text)
    text = replace_symbols(text, lang="pt")
    text = remove_aux_symbols(text)
    text = collapse_whitespace(text)
    return text


def multilingual_cleaners(text: str) -> str:
    text = lowercase(text)
    text = replace_symbols(text, lang=None)
    text = remove_aux_symbols(text)
    text = collapse_whitespace(text)
    return text


def no_cleaners(text: str) -> str:
    return text.replace("\n", "")
