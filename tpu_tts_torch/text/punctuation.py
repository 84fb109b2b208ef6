"""Strip/restore punctuation around phonemization.

Same contract as Coqui TTS `TTS/tts/utils/text/punctuation.py`: `strip`,
`strip_to_restore` → (text chunks, punc map), classmethod `restore`.
"""

import collections
import re
from enum import Enum

_DEF_PUNCS = ';:,.!?¡¿—…"«»“”'

_PUNC_IDX = collections.namedtuple("_punc_index", ["punc", "position"])


class PuncPosition(Enum):
    BEGIN = 0
    END = 1
    MIDDLE = 2


class Punctuation:
    def __init__(self, puncs: str = _DEF_PUNCS):
        self.puncs = puncs

    @staticmethod
    def default_puncs():
        return _DEF_PUNCS

    @property
    def puncs(self):
        return self._puncs

    @puncs.setter
    def puncs(self, value):
        if not isinstance(value, str):
            raise ValueError("[!] Punctuations must be of type str.")
        self._puncs = "".join(dict.fromkeys(list(value)))  # dedupe, keep order
        self.puncs_regular_exp = re.compile(rf"(\s*[{re.escape(self._puncs)}]+\s*)+")

    def strip(self, text: str) -> str:
        """Replace punctuation runs with a single space."""
        return re.sub(self.puncs_regular_exp, " ", text).strip()

    def strip_to_restore(self, text: str):
        """Split text at punctuation runs, recording each run and its position
        so `restore` can reassemble after per-chunk phonemization."""
        matches = list(re.finditer(self.puncs_regular_exp, text))
        if not matches:
            return [text], []
        if len(matches) == 1 and matches[0].group() == text:
            return [], [_PUNC_IDX(text, PuncPosition.BEGIN)]
        puncs = []
        for match in matches:
            position = PuncPosition.MIDDLE
            if match == matches[0] and text.startswith(match.group()):
                position = PuncPosition.BEGIN
            elif match == matches[-1] and text.endswith(match.group()):
                position = PuncPosition.END
            puncs.append(_PUNC_IDX(match.group(), position))
        splitted_text = []
        for idx, punc in enumerate(puncs):
            split = text.split(punc.punc)
            prefix, suffix = split[0], punc.punc.join(split[1:])
            text = suffix
            if prefix == "":
                continue
            splitted_text.append(prefix)
            if idx == len(puncs) - 1 and len(suffix) > 0:
                splitted_text.append(suffix)
        return splitted_text, puncs

    @classmethod
    def restore(cls, text, puncs):
        if not puncs:
            return text
        if not text:
            return ["".join(m.punc for m in puncs)]
        current = puncs[0]
        if current.position == PuncPosition.BEGIN:
            return cls.restore([current.punc + text[0]] + text[1:], puncs[1:])
        if current.position == PuncPosition.END:
            return [text[0] + current.punc] + cls.restore(text[1:], puncs[1:])
        if len(text) == 1:
            return cls.restore([text[0] + current.punc], puncs[1:])
        return cls.restore([text[0] + current.punc + text[1]] + text[2:], puncs[1:])
