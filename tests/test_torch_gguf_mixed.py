"""The port's GGUF path over a file that mixes quantized types, as a
"Q4_K_M"-style file does: a tiny GPT-J written with the repo's GGUF writer
with Q4_K attention projections, Q8_0 ffn_up and token embedding, and Q6_K
ffn_down and output.weight, loaded by ggml_tpu's GPTJ.from_gguf
(keep_quantized=True) and by the port's GPTJ.from_gguf(device="cpu"), both in
f32 activations.

Reader, dequantizers, repack of every type, the on-load q/k RoPE permutation
and the model run through both packages from the same bytes.  Gates as in
test_torch_gptj_q8.py, against the JAX forward run op by op with the port fed
the JAX tokens: logits NMSE <= 1e-6 at prefills of 40 and 5 tokens and at
each of 6 decode steps, the same argmax wherever the JAX margin exceeds 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.gguf import GGUFWriter
from ggml_tpu.models import gptj as jgptj
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import gptj
from tests.test_torch_gptj import _jax_prefill, _port_prefill
from tests.test_torch_gptj_q8 import assert_same_choice, teacher_forced_decode
from tests.test_torch_rules import assert_planes_equal, one_thread  # noqa: F401  (the autouse fixture)

E, LAYERS, VOCAB = 512, 2, 512
TYPES = {"attn_q": JGGMLType.Q4_K, "attn_k": JGGMLType.Q4_K, "attn_v": JGGMLType.Q4_K,
         "attn_output": JGGMLType.Q4_K, "ffn_up": JGGMLType.Q8_0, "ffn_down": JGGMLType.Q6_K,
         "output": JGGMLType.Q6_K, "token_embd": JGGMLType.Q8_0}


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    rng = np.random.default_rng(31)
    w = GGUFWriter()
    w.add_string("general.architecture", "gptj")
    for key, val in (("context_length", 128), ("embedding_length", E), ("attention.head_count", 4),
                     ("block_count", LAYERS), ("vocab_size", VOCAB), ("rope.dimension_count", 32)):
        w.add_u32("gptj." + key, val)

    def add(name, *shape, scale=0.05):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        w.add_tensor(name, arr, TYPES.get(name.split(".")[-2], JGGMLType.F32) if len(shape) == 2
                     else JGGMLType.F32)

    add("token_embd.weight", VOCAB, E)
    w.add_tensor("output_norm.weight", np.ones(E, np.float32))
    add("output_norm.bias", E)
    add("output.weight", VOCAB, E)
    add("output.bias", VOCAB)
    for i in range(LAYERS):
        pre = f"blk.{i}."
        w.add_tensor(pre + "attn_norm.weight", np.ones(E, np.float32))
        add(pre + "attn_norm.bias", E)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            add(pre + nm + ".weight", E, E)
        add(pre + "ffn_up.weight", 4 * E, E)
        add(pre + "ffn_up.bias", 4 * E)
        add(pre + "ffn_down.weight", E, 4 * E)
        add(pre + "ffn_down.bias", E)
    path = tmp_path_factory.mktemp("gptj_mixed") / "tiny-mixed.gguf"
    w.write(path)
    return path


@pytest.fixture(scope="module")
def models(gguf_path):
    jm = jgptj.GPTJ.from_gguf(gguf_path, dtype=jnp.float32, keep_quantized=True, max_seq=48, batch=1)
    tm = gptj.GPTJ.from_gguf(gguf_path, dtype=torch.float32, device="cpu", max_seq=48, batch=1)
    return jm, tm


def test_file_mixes_types_and_reads_like_jax(gguf_path):
    jg = JGGUFFile(gguf_path)
    with GGUFFile(gguf_path) as g:
        assert {int(t.ggml_type) for t in g.tensors.values()} == {
            int(t) for t in (JGGMLType.F32, JGGMLType.Q4_K, JGGMLType.Q8_0, JGGMLType.Q6_K)}
        for name in ("token_embd.weight", "output.weight", "blk.1.ffn_up.weight", "blk.0.ffn_down.weight"):
            assert g.tensors[name].ggml_type == jg.tensors[name].ggml_type == TYPES[name.split(".")[-2]]
            np.testing.assert_array_equal(g.to_float32(name), jg.to_float32(name))
    jg.close()


def test_every_weight_holds_the_jax_planes(models):
    """Each quantized matmul weight is loaded into the planes the JAX package
    holds (q/k after the RoPE column permutation), bit for bit, and decode
    routes it to the kernel of its plane kind."""
    jm, tm = models
    assert tm.cfg.rope_deinterleaved
    want_kernel = {"attn_q": "q4k_gemv_qact", "ffn_up": "q8_gemv", "ffn_down": "q8_gemv_sb",
                   "output": "q8_gemv_sb", "token_embd": "q8_gemv"}
    for name, kernel in want_kernel.items():
        key = ("" if name in ("output", "token_embd") else "blk.1.") + name + ".weight"
        assert_planes_equal(tm.params[key], jm.params[key])
        assert qmatmul.select_kernel(tm.params[key], 1) == kernel
    np.testing.assert_array_equal(tm.params["token_embd.weight@dense"].numpy(),
                                  np.asarray(jm.params["token_embd.weight@dense"]))


@pytest.mark.parametrize("t", [40, 5], ids=["prefill40-matmul", "prefill5-gemv"])
def test_gguf_prefill_matches_jax(models, t):
    jm, tm = models
    prompt = np.random.default_rng(100 + t).integers(0, VOCAB, (1, t)).astype(np.int32)
    want, _ = _jax_prefill(jm, prompt)
    got, _ = _port_prefill(tm, prompt)
    assert_same_choice(want, got, f"prefill {t}")


def test_gguf_decode_matches_jax(models):
    jm, tm = models
    prompt = np.random.default_rng(4).integers(0, VOCAB, (1, 5)).astype(np.int32)
    steps = list(teacher_forced_decode(jm, tm, prompt, 6))
    assert len(steps) == 6
    for step, (jl, tl) in enumerate(steps):
        assert_same_choice(jl, tl, f"decode step {step}")
