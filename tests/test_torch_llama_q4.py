"""A tiny Llama from a Q4_K GGUF file with a Q6_K head, in the port against
the JAX Llama on the CPU.

The file (ggml_tpu_torch.models.llama.write_random_gguf): E 512, 4 heads
over 2 kv heads (head_dim 128, GQA), 2 layers, n_ff 10240, a vocabulary of
512, rope base 500000; every 2-D weight Q4_K but output.weight Q6_K.  At
ffn_down's K = 10240 (as at Llama-3-8B's 14336) the compact planes have no
GEMV tile, so the GEMVs run H over planes expanded on every call, as the JAX
dispatch does.  Both packages load it as planes, in f32 activations; the
JAX side runs its forward op by op (Pallas kernels in interpret mode), the
port is fed the JAX run's tokens.

Gates.  A 5-token prompt (B on the K = 512 linears, H on ffn_down, F on the
head: integer sums) and 2 decode steps after it (A, H, F) are held as the
GPT-J planar tests hold theirs (test_torch_gptj_q8.assert_same_choice:
logits NMSE <= 1e-6 a step, <= 1e-4 a position, the same argmax wherever the
JAX margin exceeds 1e-3); they read 1e-14 to 1e-16 on the pinned prompt.
Like GPT-J's, a prompt where a last-bit difference crosses a rounding
boundary of an int8 activation code reads more: the prompt of seed 205 reads
4.2e-4 from its prefill on.  The 40-token prefill (C on every Q4_K linear,
G on the head) rounds every activation to bf16 before each product: the
RMSNorm's mean and rsqrt and RoPE's sin and cos differ from XLA's in the
last bits, a bf16 rounding that flips moves its element by 2**-9, and the
next linears and the SwiGLU product spread it (at n_ff 1024 the second
layer's ffn_down input differed in 13261 of its 40960 bf16 values): 3.1e-6
to 3.7e-6 over three prompts,
each position below 1.1e-5.  Its gate is NMSE <= 1e-5 a step and <= 1e-4 a
position, the same argmax where the margin exceeds 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ggml_tpu.models import llama as jllama
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import llama
from ggml_tpu_torch.quant.planar import PlanarWeight
from tests.test_torch_gptj_q8 import assert_same_choice
from tests.test_torch_llama import jax_prefill, port_prefill
from tests.test_torch_rules import assert_planes_equal, nmse, one_thread  # noqa: F401  (the autouse fixture)

CFG = llama.LlamaConfig(n_vocab=512, n_ctx=128, n_embd=512, n_head=4, n_head_kv=2, n_layer=2, n_ff=10240,
                        rope_base=500000.0)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama_q4") / "tiny-llama-q4_k.gguf"
    llama.write_random_gguf(path, CFG, seed=3, types={"output.weight": GGMLType.Q6_K})
    return path


@pytest.fixture(scope="module")
def models(gguf_path):
    jm = jllama.Llama.from_gguf(gguf_path, dtype=jnp.float32, keep_quantized=True, max_seq=MAX_SEQ)
    tm = llama.Llama.from_gguf(gguf_path, dtype=torch.float32, device="cpu", max_seq=MAX_SEQ)
    return jm, tm


def _prompt(t: int):
    return np.random.default_rng(100 + t).integers(0, CFG.n_vocab, (1, t)).astype(np.int32)


def test_every_weight_holds_the_jax_planes_and_routes_as_at_8b(models):
    """Each planar weight equals the JAX package's bit for bit, the dense
    embedding too; the K = 512 linears take A (M=1), B (M=5) and C (M=40),
    ffn_down H at M <= 32 and C above, the Q6_K head F and G."""
    jm, tm = models
    assert dataclasses.replace(tm.cfg, rms_eps=CFG.rms_eps) == CFG and tm.cfg.rms_eps == np.float32(CFG.rms_eps)
    planar = {k: v for k, v in tm.params.items() if isinstance(v, PlanarWeight)}
    assert len(planar) == 2 + 7 * CFG.n_layer
    for name, pw in planar.items():
        assert_planes_equal(pw, jm.params[name])
    np.testing.assert_array_equal(tm.params["token_embd.weight@dense"].numpy(),
                                  np.asarray(jm.params["token_embd.weight@dense"]))
    route = lambda name: [qmatmul.select_kernel(tm.params[name], m) for m in (1, 5, 40)]
    for nm in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up"):
        assert route(f"blk.1.{nm}.weight") == ["q4k_gemv_qact", "q4k_gemv_rows", "q4k_matmul"]
    assert route("blk.1.ffn_down.weight") == ["q4_gemv", "q4_gemv", "q4k_matmul"]
    assert route("output.weight") == ["q8_gemv_sb", "q8_gemv_sb", "q8_matmul"]
    assert tm.params["output.weight"].orig_type == GGMLType.Q6_K


def test_prefill_of_40_matches_jax(models):
    jm, tm = models
    want, _ = jax_prefill(jm, _prompt(40))
    got, _ = port_prefill(tm, _prompt(40))
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 40, CFG.n_vocab)
    assert nmse(want, got) <= 1e-5
    assert max(nmse(want[0, i], got[0, i]) for i in range(40)) <= 1e-4
    top2 = np.sort(want[0, -1])[-2:]
    assert top2[1] - top2[0] <= 1e-3 or np.argmax(want[0, -1]) == np.argmax(got[0, -1])


def test_short_prompt_and_decode_match_jax(models):
    jm, tm = models
    prompt = _prompt(5)
    jl, jcache = jax_prefill(jm, prompt)
    tl, tcache = port_prefill(tm, prompt)
    assert_same_choice(jl, tl, "prefill 5")
    for n_past in (5, 6):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        jl, jcache = jllama.forward(jm.params, jm.cfg, jnp.asarray([[tok]], jnp.int32),
                                    jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
        pos = torch.tensor(n_past, dtype=torch.int32)
        tl = llama.forward(tm.params, tm.cfg, torch.tensor([[tok]]), pos.expand(1), tcache, pos)[0].numpy()
        assert_same_choice(jl, tl, f"decode at {n_past}")
