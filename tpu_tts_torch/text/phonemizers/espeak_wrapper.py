"""espeak / espeak-ng subprocess phonemizer.

Counterpart of `tpu_tts/text/phonemizers/espeak_wrapper.py`, with the
external-tool strategy of Coqui TTS
`TTS/tts/utils/text/phonemizers/espeak_wrapper.py`:83: G2P runs on the host
through the espeak binary. Gated: `is_available()` is False
when no binary exists, and construction raises a clear error.
"""

import re
import shutil
import subprocess
from typing import Dict, List

from tpu_tts_torch.text.phonemizers.base import BasePhonemizer
from tpu_tts_torch.text.punctuation import Punctuation


def is_tool(name: str) -> bool:
    return shutil.which(name) is not None


def _espeak_version(binary: str) -> str:
    out = subprocess.run([binary, "--version"], capture_output=True, text=True, check=False).stdout
    m = re.search(r"(\d+\.\d+(\.\d+)?)", out)
    return m.group(1) if m else "unknown"


class ESpeak(BasePhonemizer):
    """IPA phonemization through the espeak-ng (preferred) or espeak CLI."""

    def __init__(self, language: str, backend=None, punctuations=Punctuation.default_puncs(), keep_puncs=True):
        self._backend = None
        if backend is None:
            if is_tool("espeak-ng"):
                backend = "espeak-ng"
            elif is_tool("espeak"):
                backend = "espeak"
            else:
                raise RuntimeError(
                    " [!] No espeak backend found. Install espeak-ng or espeak on the host, or use "
                    "phonemizer='en_rules' (built-in) / gruut."
                )
        self.backend = backend
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)
        if language == "en":
            self._language = "en-us"

    @property
    def backend(self):
        return self._backend

    @backend.setter
    def backend(self, backend):
        if backend not in ("espeak", "espeak-ng"):
            raise Exception("Unknown backend: %s" % backend)
        self._backend = backend

    @staticmethod
    def name():
        return "espeak"

    def phonemize_espeak(self, text: str, separator: str = "|", tie=False) -> str:
        args = [self._backend, "-q", "-b", "1"]
        if self._language:
            args += ["-v", f"{self._language}"]
        if tie:
            args.append("--ipa=1")
        else:
            args.append("--ipa=2")
        args.append(text)
        out = subprocess.run(args, capture_output=True, check=False)
        phonemized = ""
        for line in out.stdout.decode("utf8").splitlines():
            ph_decoded = (
                line.strip()
                .replace("_", separator)  # espeak separates words with '_' under --ipa
                .replace("͡", "")  # ties
                .replace("‍", "")  # zero-width joiner
            )
            # drop espeak language-switch flags like (en)
            ph_decoded = re.sub(r"\(.+?\)", "", ph_decoded)
            phonemized += ph_decoded.strip()
        if not tie:
            phonemized = phonemized.replace("_", separator)
        return phonemized

    def _phonemize(self, text, separator=None):
        return self.phonemize_espeak(text, separator or "", tie=False)

    @staticmethod
    def supported_languages() -> Dict:
        if not (is_tool("espeak-ng") or is_tool("espeak")):
            return {}
        binary = "espeak-ng" if is_tool("espeak-ng") else "espeak"
        out = subprocess.run([binary, "--voices"], capture_output=True, text=True, check=False).stdout
        langs = {}
        for line in out.splitlines()[1:]:
            cols = line.split()
            if len(cols) > 3:
                langs[cols[1]] = cols[3]
        return langs

    def version(self) -> str:
        return _espeak_version(self._backend)

    @classmethod
    def is_available(cls) -> bool:
        return is_tool("espeak") or is_tool("espeak-ng")
