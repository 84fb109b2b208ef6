"""English number → words expansion, self-contained (no `inflect`).

Covers the same surface as the reference's english/number_norm.py: commas in
numbers, currency ($/£), decimals, ordinals, and plain cardinals (with the
19xx/20xx "year-style" reading for 4-digit numbers in [1000, 3000)).
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_currency_re = re.compile(r"(£|\$)([0-9\,\.]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"-?[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]

_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_hundred(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int) -> str:
    """Spell a cardinal number."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _below_hundred(n)
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            words = number_to_words(head) + " " + name
            if rest:
                words += " " + number_to_words(rest)
            return words
    return _below_hundred(n)


def ordinal_to_words(n: int) -> str:
    """Spell an ordinal number (1st -> first)."""
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    h2, dash, last2 = last.rpartition("-")
    core = last2
    if core in _ORD_IRREGULAR:
        ord_word = _ORD_IRREGULAR[core]
    elif core.endswith("y"):
        ord_word = core[:-1] + "ieth"
    else:
        ord_word = core + "th"
    rebuilt = (h2 + dash if dash else "") + ord_word
    return (head + " " if head else "") + rebuilt


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    int_part, frac_part = m.group(1).split(".")
    frac_words = " ".join(_ONES[int(d)] for d in frac_part)
    return f"{number_to_words(int(int_part))} point {frac_words}"


def _expand_currency(m):
    unit = "pounds" if m.group(1) == "£" else "dollars"
    amount = m.group(2).replace(",", "")
    parts = amount.split(".")
    if len(parts) > 2:
        return amount + " " + unit
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1].ljust(2, "0")[:2]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = unit if dollars != 1 else unit[:-1]
        cent_unit = "cents" if cents != 1 else "cent"
        return f"{number_to_words(dollars)} {dollar_unit}, {number_to_words(cents)} {cent_unit}"
    if dollars:
        dollar_unit = unit if dollars != 1 else unit[:-1]
        return f"{number_to_words(dollars)} {dollar_unit}"
    if cents:
        cent_unit = "cents" if cents != 1 else "cent"
        return f"{number_to_words(cents)} {cent_unit}"
    return "zero " + unit


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    # year-style reading for 1000-3000 (e.g. 1984 -> nineteen eighty-four)
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + _below_hundred(num % 100)
        if num % 100 == 0:
            return _below_hundred(num // 100) + " hundred"
        hi, lo = divmod(num, 100)
        lo_words = "oh " + _ONES[lo] if lo < 10 else _below_hundred(lo)
        return f"{_below_hundred(hi)} {lo_words}".replace("-", " ")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_currency_re, _expand_currency, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
