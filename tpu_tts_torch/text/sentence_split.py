"""Rule-based sentence segmentation (replaces the reference's `pysbd`
dependency, Coqui TTS `TTS/utils/synthesizer.py`:227)."""

import re
from typing import List

_ABBREVS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc", "ltd",
    "co", "corp", "dept", "est", "fig", "gen", "gov", "hon", "jan", "feb", "mar",
    "apr", "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec", "no", "vol",
    "e.g", "i.e", "u.s", "u.k", "a.m", "p.m",
}

_BOUNDARY = re.compile(r"([.!?…]+)(\s+|$)")


def split_sentences(text: str) -> List[str]:
    """Split text into sentences, avoiding common abbreviation false-splits."""
    text = text.strip()
    if not text:
        return []
    sentences = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        end = m.end()
        before = text[start : m.start()].rstrip()
        last_word = before.split()[-1].lower().rstrip(".") if before.split() else ""
        # don't split after known abbreviations or single initials ("J.")
        if last_word in _ABBREVS or (len(last_word) == 1 and last_word.isalpha()):
            continue
        # don't split decimal numbers ("3.14")
        if m.group(1) == "." and m.start() + 1 < len(text) and text[m.start() + 1 : m.start() + 2].isdigit():
            continue
        chunk = text[start:end].strip()
        if chunk:
            sentences.append(chunk)
        start = end
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences if sentences else [text]
