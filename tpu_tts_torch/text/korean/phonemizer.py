"""Korean G2P: g2pkk pronunciation rules (optional) + jamo decomposition.

Copy of `tpu_tts/text/korean/phonemizer.py`, the surface of Coqui TTS
`TTS/tts/utils/text/korean/phonemizer.py` (`korean_text_to_phonemes`). The `jamo` package dependency is replaced with a
native Unicode decomposition (a precomposed hangul syllable U+AC00..U+D7A3
factors arithmetically into lead/vowel/tail jamo); g2pkk is applied when
installed, otherwise the orthographic jamo sequence is returned."""

_S_BASE, _L_BASE, _V_BASE, _T_BASE = 0xAC00, 0x1100, 0x1161, 0x11A7
_V_COUNT, _T_COUNT = 21, 28

_g2p = None


def hangul_to_jamo(text: str):
    """Precomposed hangul → conjoining jamo sequence (native; no `jamo` pkg)."""
    out = []
    for ch in text:
        code = ord(ch)
        if _S_BASE <= code <= 0xD7A3:
            s = code - _S_BASE
            out.append(chr(_L_BASE + s // (_V_COUNT * _T_COUNT)))
            out.append(chr(_V_BASE + (s % (_V_COUNT * _T_COUNT)) // _T_COUNT))
            t = s % _T_COUNT
            if t:
                out.append(chr(_T_BASE + t))
        else:
            out.append(ch)
    return out


def korean_text_to_phonemes(text: str, character: str = "hangeul") -> str:
    """Normalize → pronunciation rules (g2pkk when available) → jamo
    (ref phonemizer.py:8)."""
    from tpu_tts_torch.text.korean.korean import normalize

    global _g2p
    text = normalize(text)
    if _g2p is None:
        try:
            from g2pkk import G2p

            _g2p = G2p()
        except ImportError:
            _g2p = False  # unavailable; fall back to orthographic jamo
    if _g2p:
        text = _g2p(text)

    if character == "english":
        try:
            from anyascii import anyascii

            return anyascii(text)
        except ImportError:
            return text
    return "".join(hangul_to_jamo(text))
