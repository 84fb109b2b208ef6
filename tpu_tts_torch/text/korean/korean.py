"""Korean text normalization (copy of `tpu_tts/text/korean/korean.py`;
Coqui TTS `TTS/tts/utils/text/korean/korean.py` and `ko_dictionary.py`): strip hanja, expand a small
dictionary of symbols and English letters/acronyms to hangul readings."""

import re

etc_dictionary = {"1+1": "원플러스원", "2+1": "투플러스원", "%": "퍼센트", "+": "플러스"}

english_dictionary = {
    "KOREA": "코리아", "IDOL": "아이돌", "IT": "아이티", "IQ": "아이큐", "UP": "업",
    "DOWN": "다운", "PC": "피씨", "CCTV": "씨씨티비", "SNS": "에스엔에스", "AI": "에이아이",
    "CEO": "씨이오", "TV": "티비", "OK": "오케이",
    "A": "에이", "B": "비", "C": "씨", "D": "디", "E": "이", "F": "에프", "G": "지",
    "H": "에이치", "I": "아이", "J": "제이", "K": "케이", "L": "엘", "M": "엠", "N": "엔",
    "O": "오", "P": "피", "Q": "큐", "R": "알", "S": "에스", "T": "티", "U": "유",
    "V": "브이", "W": "더블유", "X": "엑스", "Y": "와이", "Z": "제트",
}

_HANJA_RE = re.compile("[⺀-⺙⺛-⻳⼀-⿕々〇〡-〩〸-〺〻㐀-䶵一-鿃豈-鶴侮-頻並-龎]")


def normalize_with_dictionary(text: str, dic: dict) -> str:
    if any(key in text for key in dic):
        pattern = re.compile("|".join(re.escape(key) for key in dic))
        return pattern.sub(lambda x: dic[x.group()], text)
    return text


def normalize_english(text: str) -> str:
    def fn(m):
        word = m.group()
        return english_dictionary.get(word, word)

    return re.sub("([A-Za-z]+)", fn, text)


def normalize(text: str) -> str:
    text = text.strip()
    text = _HANJA_RE.sub("", text)
    text = normalize_with_dictionary(text, etc_dictionary)
    text = normalize_english(text)
    return text.lower()
