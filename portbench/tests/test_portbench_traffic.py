"""The traffic generator: reproducible from the seed, the same work for
every seed, the ranges of the mix."""
import itertools

import pytest

from portbench import traffic

MIXES = ["preset-fast", "stream", "batch64"]
SEED = 2 ** 31 + 987654321   # more than 32 signed bits hold


def take(mix, seed, n):
    return list(itertools.islice(traffic.requests(mix, seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = traffic.load_mix(name)
    assert take(mix, SEED, 20) == take(mix, SEED, 20)
    assert take(mix, SEED, 20) != take(mix, SEED + 1, 20)


@pytest.mark.parametrize("name", MIXES)
def test_every_cycle_holds_the_same_sizes(name):
    mix = traffic.load_mix(name)
    n = mix["cycle"]
    for seed in (1, SEED):
        reqs = take(mix, seed, 3 * n)
        for c in range(3):
            cycle = reqs[c * n:(c + 1) * n]
            assert sorted(r.mel_tokens for r in cycle) == traffic.cycle_sizes(mix)
            assert cycle[0].mel_tokens == max(mix["mel_tokens"]) and cycle[0].greedy
            assert sum(r.greedy for r in cycle) == mix["greedy_per_cycle"]


@pytest.mark.parametrize("name", MIXES)
def test_requests_within_the_mix(name):
    mix = traffic.load_mix(name)
    lo, hi = mix["mel_tokens"]
    words = set(traffic.load_words())
    for r in take(mix, SEED, 2 * mix["cycle"]):
        assert lo <= r.mel_tokens <= hi
        assert len(r.texts) == mix.get("batch", 1) == len(r.voices)
        assert set(r.voices) <= set(mix["voices"])
        for t in r.texts:
            chars = round(r.mel_tokens / mix["mel_tokens_per_char"])
            assert chars <= len(t) <= chars + 20
            assert set(t[:-1].lower().split()) <= words and t.endswith(".")
        assert 0 < r.seed < 2 ** 31
        if r.greedy:
            assert r.kwargs(mix)["repetition_penalty"] == 1.0


def test_word_list_has_nothing_the_cleaners_expand():
    from portbench.reference.cleaners import english_cleaners
    for w in traffic.load_words():
        assert english_cleaners(w + ".") == w + "."
