"""Arabic-numeral → Chinese-character expansion for Mandarin cleaners.

Copy of `tpu_tts/text/chinese_mandarin/numbers.py`, the surface of Coqui TTS
`TTS/tts/utils/text/chinese_mandarin/numbers.py`
(`_num2chinese`, `replace_numbers_to_characters_in_text`), implemented from the
standard Chinese numeral grammar: 4-digit groups read with 十/百/千 inner units
and 万/亿/… group units, interior zero runs collapse to a single 零, and
trailing zeros are silent. Decimals are read digit-by-digit after 点.
"""

import re

_DIGITS = "零一二三四五六七八九"
_DIGITS_O = "〇一二三四五六七八九"
_DIGITS_BIG = "零壹贰叁肆伍陆柒捌玖"
_UNITS1 = "十百千"
_UNITS1_BIG = "拾佰仟"
_UNITS2 = "万亿兆京垓秭穰沟涧正载"


def _group_to_chinese(group: str, digits: str, units1: str, two: str) -> str:
    """Read one 1-4 digit group (no group unit), e.g. '3014' → 三千零十四."""
    out = []
    n = len(group)
    pending_zero = False
    for i, ch in enumerate(group):
        pos = n - 1 - i  # power of ten within the group
        d = int(ch)
        if d == 0:
            if out:
                pending_zero = True
            continue
        if pending_zero:
            out.append(digits[0])
            pending_zero = False
        if pos == 1 and d == 1 and not out:
            # 10..19 read as 十X, not 一十X
            out.append(units1[0])
            continue
        c = two if (d == 2 and pos >= 2 and two != digits[2]) else digits[d]
        out.append(c + (units1[pos - 1] if pos > 0 else ""))
    return "".join(out)


def _num2chinese(num: str, big: bool = False, simp: bool = True, o: bool = False, twoalt: bool = False) -> str:
    """Convert an arabic number string to Chinese characters (ref numbers.py:12)."""
    nd = str(num)
    if "e" in nd or "E" in nd:
        raise ValueError("scientific notation is not supported")
    if abs(float(nd)) >= 1e48:
        raise ValueError("number out of range")
    if o:
        twoalt = False
    digits = _DIGITS_BIG if big else (_DIGITS_O if o else _DIGITS)
    units1 = _UNITS1_BIG if big else _UNITS1
    two = ("贰" if big else ("两" if twoalt else digits[2])) if simp else ("貳" if big else ("兩" if twoalt else digits[2]))

    result = []
    if nd.startswith("+"):
        result.append("正" if simp else "正")
    elif nd.startswith("-"):
        result.append("负" if simp else "負")
    body = nd.lstrip("+-")
    integer, _, frac = body.partition(".")

    if int(integer or "0") == 0:
        result.append(digits[0])
    else:
        # split into 4-digit groups, most significant first
        groups = []
        g = integer
        while g:
            groups.append(g[-4:])
            g = g[:-4]
        groups.reverse()
        n_groups = len(groups)
        parts = []
        prev_nonzero = False
        for gi, group in enumerate(groups):
            gpow = n_groups - 1 - gi  # index into _UNITS2 (gpow-1) when > 0
            if int(group) == 0:
                if prev_nonzero and gi < n_groups - 1:
                    prev_nonzero = False
                continue
            txt = _group_to_chinese(group.lstrip("0") or "0", digits, units1, two)
            # a dropped leading digit inside the group needs a 零 connector
            if gi > 0 and (len(group.lstrip("0")) < 4 or not prev_nonzero):
                if parts:
                    txt = digits[0] + txt
            if gpow > 0:
                txt += _UNITS2[gpow - 1]
            parts.append(txt)
            prev_nonzero = True
        result.append("".join(parts).strip(digits[0]) or digits[0])

    if frac:
        result.append("点" if simp else "點")
        result.append("".join(digits[int(c)] for c in frac))
    return "".join(result)


def _number_replace(match) -> str:
    return _num2chinese(match.group())


def replace_numbers_to_characters_in_text(text: str) -> str:
    """Replace every arabic number with its Chinese reading (ref numbers.py:105)."""
    return re.sub(r"[0-9]+(?:\.[0-9]+)?", _number_replace, text)
