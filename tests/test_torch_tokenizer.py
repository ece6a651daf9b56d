"""The port's pure-Python BPE gives the ids of the HF-tokenizers original,
and its decode the text of the original's."""
import random

import numpy as np
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



@pytest.mark.parametrize("text", SENTENCES)
def test_decode_round_trip_matches_jax(tokenizers, text):
    ref, port = tokenizers
    ids = port.encode(text)
    assert port.decode(ids) == ref.decode(ids)


def test_random_ids_decode_as_jax(tokenizers):
    """500 seeded id sequences of 0-29 ids, some at or above the
    vocabulary's 255 symbols."""
    ref, port = tokenizers
    rng = np.random.default_rng(0)
    for _ in range(500):
        ids = rng.integers(0, 300, rng.integers(0, 30)).tolist()
        assert port.decode(ids) == ref.decode(ids), ids


def test_decode_drops_ids_out_of_the_vocabulary(tokenizers):
    ref, port = tokenizers
    ids = port.encode("Hello world.")
    assert port.decode([300]) == ref.decode([300]) == ""
    assert port.decode([255, *ids, 1000]) == ref.decode([255, *ids, 1000]) == "hello world."


def test_decode_of_a_negative_id_raises(tokenizers):
    ref, port = tokenizers
    for tok in (ref, port):
        with pytest.raises(OverflowError):
            tok.decode([5, -1])


def test_decode_takes_numpy_ints_and_tensors(tokenizers):
    ref, port = tokenizers
    ids = port.encode(SENTENCES[2])
    want = ref.decode(ids)
    assert port.decode(np.asarray(ids, np.int32)) == port.decode(torch.tensor(ids)) == want
    assert port.decode([np.int64(i) for i in ids]) == want
