"""A tiny GPT-J over all eleven IQ* and TQ* GGUF types, in the port against
the JAX package on the CPU.

The file (ggml_tpu_torch.models.gptj.write_random_gguf(types=)): E 512, 2
layers, a vocabulary of 512 (a byte-level BPE), its 14 matmul weights cycling
through IQ4_NL, IQ4_XS, IQ3_S, IQ3_XXS, IQ2_S, IQ2_XS, IQ2_XXS, IQ1_M, IQ1_S,
TQ2_0 and TQ1_0 in file order (ffn_down of layer 0 IQ1_M, groups of 8 with
offsets; k and v of layer 1 TQ2_0 and TQ1_0, groups of 256).  Loaded by
ggml_tpu's GPTJ.from_gguf(keep_quantized=True) and the port's
GPTJ.from_gguf(device="cpu"), both in f32 activations: every weight holds the
JAX planes bit for bit; prefills of 40 and 5 tokens and 3 decode steps (the
port fed the JAX tokens) are gated as test_torch_gguf_mixed.py gates them
(assert_same_choice: logits NMSE <= 1e-6, <= 1e-4 a position, the same argmax
wherever the JAX margin exceeds 1e-3), against the JAX forward run op by op
(Pallas in interpret mode).  The dense load equals JAX's bit for bit, and
`generate --quantized` prints the in-process generate's text.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gpt2, gptj
from ggml_tpu_torch.tokenizer import BPETokenizer
from tests.test_torch_gptj import _jax_prefill, _port_prefill
from tests.test_torch_gptj_q8 import assert_same_choice, teacher_forced_decode
from tests.test_torch_rules import assert_planes_equal, one_thread  # noqa: F401  (the autouse fixture)
from tests.test_torch_tokenizer import bpe_vocab

CFG = gptj.GPTJConfig(n_vocab=512, n_ctx=128, n_embd=512, n_head=4, n_layer=2, n_rot=32)
TYPES = [GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ3_S, GGMLType.IQ3_XXS, GGMLType.IQ2_S, GGMLType.IQ2_XS,
         GGMLType.IQ2_XXS, GGMLType.IQ1_M, GGMLType.IQ1_S, GGMLType.TQ2_0, GGMLType.TQ1_0]
WEIGHT_TYPES = {name: TYPES[i % len(TYPES)] for i, name in enumerate(gptj.matmul_weight_names(CFG))}
MAX_SEQ = 48
PROMPT = "the quick brown fox jumps over the lazy dog"


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    tokens, merges = bpe_vocab(200)
    tokens = tokens + [f"<|extra_{i}|>" for i in range(CFG.n_vocab - len(tokens))]
    path = tmp_path_factory.mktemp("gptj_iq") / "tiny-iq.gguf"
    gptj.write_random_gguf(path, CFG, seed=13, types=WEIGHT_TYPES,
                           tokenizer=dict(model="gpt2", tokens=tokens, merges=merges, eos_token_id=300))
    return path


@pytest.fixture(scope="module")
def models(gguf_path):
    jm = jgptj.GPTJ.from_gguf(gguf_path, dtype=jnp.float32, keep_quantized=True, max_seq=MAX_SEQ, batch=1)
    tm = gptj.GPTJ.from_gguf(gguf_path, dtype=torch.float32, device="cpu", max_seq=MAX_SEQ, batch=1)
    return jm, tm


def _prompt(t: int):
    return np.random.default_rng(100 + t).integers(0, CFG.n_vocab, (1, t)).astype(np.int32)


def test_every_weight_holds_the_jax_planes(gguf_path, models):
    """Each of the 14 matmul weights is in its type in the file and loads
    into the JAX package's planes (q and k after the RoPE permutation) bit
    for bit; planar_matmul routes groups of 8 and 256 to kernel G at M = 1."""
    jm, tm = models
    with GGUFFile(gguf_path) as g:
        assert {n: GGMLType(g.tensors[n].ggml_type) for n in WEIGHT_TYPES} == WEIGHT_TYPES
    assert set(WEIGHT_TYPES.values()) == set(TYPES)
    for name, t in WEIGHT_TYPES.items():
        pw = tm.params[name]
        assert_planes_equal(pw, jm.params[name])
        want = "q8_matmul" if pw.group in (8, 256) else "q8_gemv"
        assert pw.orig_type == t and qmatmul.select_kernel(pw, 1) == want, name
        assert qmatmul.select_kernel(pw, 40) == "q8_matmul"
    assert tm.params["blk.0.ffn_down.weight"].group == 8 and tm.params["blk.1.attn_k.weight"].group == 256
    np.testing.assert_array_equal(tm.params["token_embd.weight@dense"].numpy(),
                                  np.asarray(jm.params["token_embd.weight@dense"]))


@pytest.mark.parametrize("t", [40, 5], ids=["prefill40-matmul", "prefill5"])
def test_prefill_matches_jax(models, t):
    jm, tm = models
    want, _ = _jax_prefill(jm, _prompt(t))
    got, _ = _port_prefill(tm, _prompt(t))
    assert got.shape == np.asarray(want).shape == (1, t, CFG.n_vocab)
    assert_same_choice(want, got, f"prefill {t}")


def test_decode_matches_jax(models):
    """3 decode steps after the 5-token prefill (the JAX run the prefill test
    made), both fed the JAX tokens."""
    jm, tm = models
    steps = list(teacher_forced_decode(jm, tm, _prompt(5), 3))
    assert len(steps) == 3
    for step, (jl, tl) in enumerate(steps):
        assert_same_choice(jl, tl, f"decode step {step}")


def test_dense_load_matches_jax(gguf_path):
    """keep_quantized=False: every tensor dequantized as JAX does, bit for bit."""
    jg = JGGUFFile(gguf_path)
    with GGUFFile(gguf_path) as g:
        got = gpt2.load_params(g, torch.float32, keep_quantized=False, device="cpu")
    want = jgpt2.load_params(jg, dtype=jnp.float32, keep_quantized=False)
    jg.close()
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w), err_msg=name)


def test_generate_quantized_cli_prints_the_in_process_text(gguf_path, models, capsys):
    _, tm = models
    with GGUFFile(gguf_path) as g:
        tok = BPETokenizer.from_gguf(g)
    ids = np.asarray([tok.encode(PROMPT)], np.int32)
    qmatmul._selection_log.clear()
    cli.main([str(gguf_path), "-p", PROMPT, "-n", "4", "--quantized", "--top-k", "1", "--verbose",
              "--device", "cpu"])
    got = capsys.readouterr()
    assert got.out == PROMPT + tok.decode(tm.generate(ids, 4)) + "\n"
    # the --verbose report: every site's wrappers, kernel G at M = 1 where the groups are 8 or 256
    want = {}
    for name in WEIGHT_TYPES:
        if name != "token_embd.weight":
            pw = tm.params[name]
            want.setdefault((pw.kind, pw.k, pw.n, "gemv-M"), set()).add(qmatmul.select_kernel(pw, 1))
    assert _report(got.err) == want
    assert want[("q8", 2048, 512, "gemv-M")] == {"q8_matmul", "q8_gemv"}  # ffn_down: IQ1_M, then IQ3_S


def _report(err: str) -> dict:
    sites = {}
    for line in err.splitlines():
        m = re.match(r"\s+(\w+) K=(\d+)\s+N=(\d+)\s+(\S+) -> (.+)$", line)
        if m:
            sites[(m[1], int(m[2]), int(m[3]), m[4])] = set(m[5].split(", "))
    return sites
