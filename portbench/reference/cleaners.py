"""English text cleaners of the reference tokenizer (reference
tortoise/utils/tokenizer.py:12-150), frozen here so that the benchmark's
reference tokenizes its texts without the program: abbreviations, numbers,
currency and ordinals spelled out, ascii transliteration, lowercase,
collapsed whitespace.
"""
from __future__ import annotations

import re
import unicodedata

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


# ---------------------------------------------------------------------------
# Number verbalization (inflect-compatible for the subset tortoise uses)
# ---------------------------------------------------------------------------

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [
    (10 ** 33, "decillion"), (10 ** 30, "nonillion"), (10 ** 27, "octillion"),
    (10 ** 24, "septillion"), (10 ** 21, "sextillion"), (10 ** 18, "quintillion"),
    (10 ** 15, "quadrillion"), (10 ** 12, "trillion"), (10 ** 9, "billion"),
    (10 ** 6, "million"), (10 ** 3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def _three_digits(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_UNITS[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Integer -> English words, in inflect's ``andword=''`` style:
    groups joined with ", ", e.g. 1234567 ->
    "one million, two hundred thirty-four thousand, five hundred sixty-seven".
    """
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _two_digits(n)
    if n < 1000:
        return _three_digits(n)
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            head_words = number_to_words(head) + " " + name
            if rest == 0:
                return head_words
            return head_words + ", " + number_to_words(rest)
    raise AssertionError("unreachable")


def number_to_words_grouped2(n: int) -> str:
    """inflect ``number_to_words(num, group=2, zero='oh')`` after the
    reference's ``.replace(', ', ' ')`` — used for years (e.g. 1984 ->
    "nineteen eighty-four", 2007 -> "twenty oh seven")."""
    digits = str(n)
    if len(digits) % 2 == 1:
        digits = digits[0] + " " + digits[1:]  # leading single digit group
        groups = [digits.split(" ")[0]] + re.findall("..", digits.split(" ")[1])
    else:
        groups = re.findall("..", digits)
    words = []
    for g in groups:
        v = int(g)
        if v == 0:
            words.append("zero zero" if len(g) == 2 else "zero")
        elif v < 10 and len(g) == 2:
            words.append("oh " + _UNITS[v])
        else:
            words.append(_two_digits(v) if v < 100 else _three_digits(v))
    return " ".join(words)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    # Ordinalize the final word only.
    head, _, last = words.rpartition(" ")
    prefix = (head + " ") if head else ""
    if "-" in last:
        tens, _, unit = last.partition("-")
        return prefix + tens + "-" + _ORDINAL_IRREGULAR.get(unit, _regular_ordinal(unit))
    return prefix + _ORDINAL_IRREGULAR.get(last, _regular_ordinal(last))


def _regular_ordinal(word: str) -> str:
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word.endswith("t"):  # "eight" handled as irregular; covers "hundred"? no
        return word + "h"
    return word + "th"


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words_grouped2(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text


def convert_to_ascii(text: str) -> str:
    """Lightweight unidecode: NFKD-decompose, strip combining marks, map a few
    common punctuation/letter cases, then drop anything non-ascii."""
    for src, dst in (
        ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'"), ("—", "--"), ("–", "-"),
        ("…", "..."), ("æ", "ae"), ("Æ", "AE"), ("œ", "oe"), ("Œ", "OE"),
        ("ß", "ss"), ("ø", "o"), ("Ø", "O"), ("ð", "d"), ("þ", "th"), ("£", "PS"),
    ):
        text = text.replace(src, dst)
    decomposed = unicodedata.normalize("NFKD", text)
    stripped = "".join(c for c in decomposed if not unicodedata.combining(c))
    return stripped.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace (for non-English text)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline (reference tokenizer.py:142-150)."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    text = text.replace('"', "")
    return text
