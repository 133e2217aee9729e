"""The port's tokenizers (ggml_tpu_torch.tokenizer) and the registry's
load_tokenizer against the JAX package's, on the CPU.

BPE: a byte-level vocabulary whose 300 merges are learned from a corpus
drawn with a numpy seed (contractions, whitespace runs, digits,
punctuation, non-ASCII text).  SPM: the toy vocabulary of
tests/test_tokenizer_spm.py with byte fallback.  WPM: its BERT vocabulary.
Gates: ids and decoded strings identical to the JAX tokenizers'; from_gguf
reads a GGUF the port wrote; load_tokenizer picks the JAX class or None.
"""

import numpy as np
import pytest

from ggml_tpu import tokenizer as jtok
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models.registry import load_tokenizer as jax_load_tokenizer
from ggml_tpu_torch import tokenizer as ttok
from ggml_tpu_torch.gguf import GGUFFile, GGUFWriter
from ggml_tpu_torch.models.registry import load_tokenizer
from tests import test_tokenizer_spm as spm_tests
from tests.test_torch_rules import one_thread  # noqa: F401  (the autouse fixture)

_WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "don't", "it's", "we're", "they've",
          "I'm", "you'll", "he'd", "Hello", "World", "café", "naïve", "über", "日本語", "données", "😀", "42",
          "2024", "3.14", "1,000", "!", "?", "...", "--", "(x)", "$5", "e-mail", "snake_case", "x+y=z"]
_SPACES = [" ", " ", " ", "  ", "\n", "\t", " \n "]

TEXTS = [
    "Hello world",
    "I'm sure it's fine, isn't it? We'll see; they'd've known.",
    "a   b\t\tc\n\n d   ",
    "   leading and trailing   ",
    "1234567 89 3.14159 2024-10-17 1,000,000",
    "!!!...??? -- (parens) [brackets] {braces} <tags> @#$%^&*",
    "café naïve über 日本語のテキスト données 😀👍🏽",
    "MiXeD CaSe snake_case camelCase x+y=z",
    "",
]


_SYLLABLES = ["ka", "to", "ri", "men", "sha", "lo", "qu", "ex", "in", "ter", "pre", "ing", "ed", "ly", "tion",
              "ness", "Ab", "Zu", "é", "ö", "ß", "語"]


def corpus(seed: int = 0, n: int = 3000) -> str:
    """Seeded text: words of _WORDS and words of 1-4 _SYLLABLES, joined by
    spaces, whitespace runs and newlines."""
    rng = np.random.default_rng(seed)
    words = [str(rng.choice(_WORDS)) if rng.random() < 0.4 else
             "".join(rng.choice(_SYLLABLES, rng.integers(1, 5))) for _ in range(n)]
    seps = rng.choice(_SPACES, n)
    return "".join(w + s for w, s in zip(words, seps))


def bpe_vocab(n_merges: int = 300, seed: int = 0) -> tuple[list[str], list[str]]:
    """(tokens, merges) of a byte-level BPE learned from corpus(seed)."""
    merges = ttok.learn_merges(corpus(seed), n_merges)
    return ttok.byte_level_vocab(merges), merges


@pytest.fixture(scope="module")
def bpe_pair():
    tokens, merges = bpe_vocab()
    return jtok.BPETokenizer(tokens, merges), ttok.BPETokenizer(tokens, merges)


def test_learned_vocabulary_is_byte_level():
    tokens, merges = bpe_vocab()
    assert len(merges) == 300 and len(set(tokens)) == len(tokens) > 256 + 200
    assert tokens[:256] == [ttok.bytes_to_unicode()[b] for b in range(256)]
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    assert ttok._PAT.pattern == jtok._PAT.pattern and ttok._PAT.flags == jtok._PAT.flags


@pytest.mark.parametrize("text", TEXTS + [corpus(7, 200)], ids=[f"text{i}" for i in range(len(TEXTS))] + ["corpus"])
def test_bpe_matches_jax(bpe_pair, text):
    jt, tt = bpe_pair
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids) == text


def test_bpe_decodes_any_ids_as_jax(bpe_pair):
    """Arbitrary id sequences (split UTF-8 sequences among them) decode to
    the same text, replacement characters included."""
    jt, tt = bpe_pair
    rng = np.random.default_rng(1)
    for _ in range(50):
        ids = rng.integers(0, len(tt.encoder), rng.integers(1, 12)).tolist()
        assert tt.decode(ids) == jt.decode(ids)


@pytest.mark.parametrize("text,add_bos", [("hello", True), ("hello", False), ("hé", False), ("hello hello", True),
                                          ("he llo  wörld", True), ("", True)])
def test_spm_matches_jax(text, add_bos):
    j = spm_tests._toy()
    t = ttok.SPMTokenizer(j.tokens, j.scores, bos_id=j.bos_id)
    ids = t.encode(text, add_bos=add_bos)
    assert ids == j.encode(text, add_bos=add_bos)
    start = 1 if add_bos else 0
    assert t.decode(ids[start:]) == j.decode(ids[start:])


@pytest.mark.parametrize("text", ["unaffable", "Hello, world!", "playing the unaffable world", "qzx hello!!",
                                  "  PLAY,the\tworld  "])
def test_wpm_matches_jax(text):
    j, t = jtok.WPMTokenizer(spm_tests.TestWPM.VOCAB), ttok.WPMTokenizer(spm_tests.TestWPM.VOCAB)
    for special in (True, False):
        ids = t.encode(text, add_special=special)
        assert ids == j.encode(text, add_special=special)
        assert t.decode(ids) == j.decode(ids)


def _write(path, **meta):
    w = GGUFWriter()
    w.add_string("general.architecture", "gpt2")
    for key, val in meta.items():
        if isinstance(val, str):
            w.add_string(f"tokenizer.ggml.{key}", val)
        elif isinstance(val, int):
            w.add_u32(f"tokenizer.ggml.{key}", val)
        else:
            w.add_array(f"tokenizer.ggml.{key}", val)
    w.write(path)
    return path


def test_from_gguf_and_load_tokenizer_match_jax(tmp_path):
    tokens, merges = bpe_vocab()
    j = spm_tests._toy()
    files = {
        "bpe": _write(tmp_path / "bpe.gguf", model="gpt2", tokens=tokens, merges=merges),
        "bpe-no-model": _write(tmp_path / "bare.gguf", tokens=tokens, merges=merges),
        "spm": _write(tmp_path / "spm.gguf", model="llama", tokens=j.tokens, scores=[float(s) for s in j.scores],
                      bos_token_id=1),
        "wpm": _write(tmp_path / "wpm.gguf", model="bert", tokens=spm_tests.TestWPM.VOCAB, unknown_token_id=1,
                      cls_token_id=2, seperator_token_id=3),
        "none": _write(tmp_path / "none.gguf", model="gpt2"),
    }
    text = TEXTS[1] + " hello hé"
    for kind, path in files.items():
        jg = JGGUFFile(path)
        with GGUFFile(path) as g:
            got, want = load_tokenizer(g), jax_load_tokenizer(jg)
            if kind == "none":
                assert got is None and want is None
                continue
            assert type(got).__name__ == type(want).__name__, kind
            assert got.encode(text) == want.encode(text), kind
            if kind == "wpm":  # WordPiece is built by its own from_gguf (neither registry picks it)
                wt, jw = ttok.WPMTokenizer.from_gguf(g), jtok.WPMTokenizer.from_gguf(jg)
                assert (wt.unk_id, wt.cls_id, wt.sep_id) == (jw.unk_id, jw.cls_id, jw.sep_id) == (1, 2, 3)
                assert wt.encode("Hello, world!") == jw.encode("Hello, world!")
        jg.close()
