"""The port's pure-Python BPE gives the ids of the HF-tokenizers original."""
import random

import pytest
import torch

from tortoise_tpu.utils.tokenizer import VoiceBpeTokenizer as JaxTokenizer
from tortoise_tpu_torch.utils.tokenizer import VoiceBpeTokenizer

torch.set_num_threads(2)

SENTENCES = [
    "",
    "Hello world.",
    "I paid $3.50 for 2 apples on 12/25/2023!",
    "The 1st, 2nd and 103rd runners finished at 10:45.",
    "Café naïve façade: résumé, jalapeño, Straße.",
    "[I am really sad,] Please feed me.",
    "Dr. Smith's rule: don't panic; 42% of the time it works?!",
    "   multiple   spaces\tand\nnewlines  ",
    "[STOP] literal [UNK] tokens [SPACE] in the text",
    "xyzzy qwrtp zzz -- (parenthetical) 'single' \"double\"",
]


@pytest.fixture(scope="module")
def tokenizers():
    return JaxTokenizer(), VoiceBpeTokenizer()


@pytest.mark.parametrize("text", SENTENCES)
def test_ids_match(tokenizers, text):
    ref, port = tokenizers
    assert port.encode(text) == ref.encode(text)


def test_random_text_matches(tokenizers):
    ref, port = tokenizers
    rnd = random.Random(0)
    chars = "abcdefghijklmnopqrstuvwxyz ABCXYZ.,!?'-;:()[]éü"
    for _ in range(300):
        text = "".join(rnd.choice(chars) for _ in range(rnd.randint(0, 50)))
        assert port.encode(text) == ref.encode(text), repr(text)

