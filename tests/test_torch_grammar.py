"""The port's GBNF grammar (ggml_tpu_torch.grammar) against the JAX
package's, on the CPU.

Gates: parse_gbnf gives JAX's rules field by field for tests/test_grammar.py's
grammars; GrammarState accepts and rejects the same strings; GrammarSampler
picks the same ids over seeded logit sequences (EOS included), its token a
long tensor on the logits' device; the three-digit constrained generation of
tests/test_grammar.py, run in the port on the same tiny GPT-2, gives JAX's ids.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu import grammar as jgrammar
from ggml_tpu_torch import grammar as tgrammar
from tests.test_torch_rules import one_thread  # noqa: F401  (the autouse fixture)

GRAMMARS = {
    "literals": 'root ::= "yes" | "no"',
    "classes": "root ::= [1-9] [0-9]*",
    "repeat": 'root ::= "a"+ "b"?',
    "refs": r'''
    root ::= pair ("," pair)*
    pair ::= key "=" value
    key  ::= [a-z]+
    value ::= [0-9]+ | "\"" [a-z]* "\""
    ''',
    "newline": r'root ::= "\n" [^\n]+',
    "negated": r'root ::= [^ab] "A"',
    "escapes": r'root ::= "\x41" [à-ÿ]+ ("" | "\t") # comment',
    "words": "root ::= [a-z]+ (\" \" [a-z]+)*",
}
STRINGS = ["yes", "no", "maybe", "ye", "7", "1024", "0123", "a", "aaab", "b", "abb", "x=1", 'x=1,yz="abc"',
           "x=1,", "X=1", "\nhello", "\n", "cA", "aA", "Aàÿ", "Aàÿ\t", "A", "ab cd", "ab  cd", "ab ", ""]


def _plain(rules: dict) -> dict:
    """Rules with every char set as (ranges, negated)."""
    elem = lambda e: ("char", e[1].ranges, e[1].negated) if e[0] == "char" else e
    return {name: [tuple(elem(e) for e in alt) for alt in alts] for name, alts in rules.items()}


@pytest.mark.parametrize("name", list(GRAMMARS))
def test_parse_and_accept_match_jax(name):
    text = GRAMMARS[name]
    want, got = jgrammar.parse_gbnf(text), tgrammar.parse_gbnf(text)
    assert list(got) == list(want)
    assert _plain(got) == _plain(want)
    for s in STRINGS:
        js, ts = jgrammar.GrammarState(want).accepts_text(s), tgrammar.GrammarState(got).accepts_text(s)
        assert (ts is None) == (js is None), (name, s)
        if ts is not None:
            assert ts.can_end == js.can_end, (name, s)
            assert len(ts.stacks) == len(js.stacks), (name, s)


def test_parse_errors_match_jax():
    for bad in ("root ::= [a-z", "x ::= \"a\"", "root ::= (\"a\"", "root = \"a\"", 'root ::= "\\q"'):
        with pytest.raises(Exception) as want:
            jgrammar.parse_gbnf(bad)
        with pytest.raises(want.type):
            tgrammar.parse_gbnf(bad)


class _ByteTok:
    """id i <-> chr(i) toy tokenizer."""

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


@pytest.mark.parametrize("gbnf,eos", [('root ::= "hi" | "ho"', 0), ("root ::= [a-z]+ (\" \" [a-z]+)*", 3),
                                      ("root ::= [1-9] [0-9] [0-9]", -1)])
def test_sampler_picks_jax_ids(gbnf, eos):
    """Seeded logit rows, some with EOS or an inadmissible token on top, fed
    to both samplers step by step: the same ids, the same failures."""
    rng = np.random.default_rng(len(gbnf))
    js = jgrammar.GrammarSampler(gbnf, _ByteTok(), eos_id=eos)
    ts = tgrammar.GrammarSampler(gbnf, _ByteTok(), eos_id=eos)
    for step in range(8):
        lg = rng.normal(size=(1, 128)).astype(np.float32)
        if step % 3 == 1 and eos >= 0:
            lg[0, eos] = 100.0
        if step % 3 == 2:
            lg[0, ord("z")] = 50.0
        try:
            want, _ = js(lg)
        except ValueError:
            with pytest.raises(ValueError):
                ts(torch.from_numpy(lg))
            return
        got, key = ts(torch.from_numpy(lg), "key")
        assert key == "key" and got.dtype == torch.long and got.device.type == "cpu" and got.shape == (1,)
        assert int(got[0]) == int(want[0]), step
        assert ts.state.can_end == js.state.can_end


def test_sampler_reads_bf16_logits():
    """A bf16 row (a bf16 model's logits) is scanned as JAX scans its f32 copy."""
    rng = np.random.default_rng(5)
    lg = torch.from_numpy(rng.normal(size=(1, 128)).astype(np.float32)).to(torch.bfloat16)
    gbnf = "root ::= [a-z]+"
    js = jgrammar.GrammarSampler(gbnf, _ByteTok())
    ts = tgrammar.GrammarSampler(gbnf, _ByteTok())
    for _ in range(4):
        assert int(ts(lg)[0][0]) == int(js(lg.float().numpy())[0][0])


def test_constrained_generation_three_digits_matches_jax(tmp_path):
    """tests/test_grammar.py's constrained generation (vocab 256, E 32, one
    layer; the weights from init_random_params): three digits, then only EOS."""
    from ggml_tpu.gguf import GGUFFile as JGGUFFile
    from ggml_tpu.models.common import generate as jgenerate
    from ggml_tpu.models.gpt2 import GPT2 as JGPT2
    from ggml_tpu.tokenizer import BPETokenizer as JBPETokenizer
    from ggml_tpu.tokenizer import bytes_to_unicode
    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.models.gpt2 import GPT2
    from ggml_tpu_torch.tokenizer import BPETokenizer
    from tests.test_torch_rules import tiny_gpt2_gguf

    b2u = bytes_to_unicode()
    shape = dict(n_vocab=256, n_ctx=64, n_embd=32, n_head=4, n_layer=1)
    path = tiny_gpt2_gguf(tmp_path / "g.gguf", shape, [b2u[b] for b in range(256)], [])

    gbnf = "root ::= [1-9] [0-9] [0-9]"
    jtok = JBPETokenizer.from_gguf(JGGUFFile(path))
    prompt = np.asarray([jtok.encode("num: ")], np.int32)
    jm = JGPT2.from_gguf(str(path), max_seq=32, batch=1)
    want = jgenerate(jm, prompt, 5, sampler=jgrammar.GrammarSampler(gbnf, jtok, eos_id=254),
                     cache_dtype=jnp.float32)

    with GGUFFile(path) as g:
        tok = BPETokenizer.from_gguf(g)
    m = GPT2.from_gguf(str(path), max_seq=32, batch=1, device="cpu")
    got = m.generate(prompt, 5, sampler=tgrammar.GrammarSampler(gbnf, tok, eos_id=254))
    assert got == want
    assert re.match(r"^[1-9][0-9][0-9]", tok.decode(got)) and got[3:] == [254, 254]
