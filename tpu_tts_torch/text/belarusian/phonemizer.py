"""Belarusian phonemization (copy of `tpu_tts/text/belarusian/phonemizer.py`;
Coqui TTS `TTS/tts/utils/text/belarusian/phonemizer.py`): delegates to the
external `belarusian-text-normalizer` fanetyka module, which Coqui finds
through the BEL_FANETYKA_JAR environment variable; here the python package is
tried directly and a clear error raised when unavailable."""


def belarusian_text_to_phonemes(text: str) -> str:
    try:
        from belarusian_fanetyka import fanetyka  # optional external package
    except ImportError as e:
        raise RuntimeError(
            " [!] Belarusian phonemization requires the `belarusian-fanetyka` package (or Coqui TTS's "
            "BEL_FANETYKA_JAR toolchain), which is not installed."
        ) from e
    return fanetyka(text)
