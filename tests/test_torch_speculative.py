"""The port's speculative decoding (ggml_tpu_torch.speculative) and its paged
verify step against the JAX package's on the CPU.

- greedy speculative_generate on a tiny f32 Llama (the f32 GGUF file of
  tests/test_torch_serve.py, GQA 4/2; bf16 caches, each model's default as
  in plain generate) with a self-draft and an unrelated draft: ids and
  rounds equal JAX's, ids equal the port's plain greedy generate; k = 1 and
  outputs of 4 and 1 tokens;
- on a tiny GPT-J of synthesized Q4_K planes (the JAX package's, carried
  over as numpy) with a 1-layer self-draft sharing the target's tensors:
  ids and rounds equal JAX's (its Pallas kernels in interpret mode inside
  its jitted loop);
- the sampled decoder: the first token's marginal over 400 seeds within
  total variation 0.15 of the analytic warped target distribution (JAX's
  softmax(warp_logits) of its forward; a 400-draw empirical distribution
  over about 12 bins is expected about 0.07 away), nothing outside its
  support, and a self-draft accepting every draft (p = q);
- make_paged_verify_step (T = 3 rows a slot, one slot across a page edge,
  an inactive slot writing the trash page) against JAX's run op by op:
  logits NMSE <= 1e-10 (XLA's and PyTorch's sums differ in last bits),
  pools within 1e-5 relative; the llama family's step and the generic
  adapter over GPT-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu import speculative as jspec
from ggml_tpu.dtypes import GGMLType as JGGMLType
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.models import llama as jllama
from ggml_tpu.sampling import warp_logits as jwarp_logits
from ggml_tpu_torch import paged_kv, speculative
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.gguf import GGUFWriter
from ggml_tpu_torch.models import gpt2, gptj, llama
from tests.test_torch_llama import random_params as llama_params
from tests.test_torch_rules import nmse, one_thread, params_to_numpy  # noqa: F401  (the autouse fixture)
from tests.test_torch_serve import LLAMA, MAX_SEQ, _load, files  # noqa: F401  (the module fixture)


def write_llama(path, seed: int):
    """A tiny f32 Llama of tests/test_torch_serve.py's shape from `seed`."""
    w = GGUFWriter()
    w.add_string("general.architecture", "llama")
    for key, val in (("context_length", LLAMA.n_ctx), ("embedding_length", LLAMA.n_embd),
                     ("attention.head_count", LLAMA.n_head), ("attention.head_count_kv", LLAMA.n_head_kv),
                     ("block_count", LLAMA.n_layer), ("feed_forward_length", LLAMA.n_ff),
                     ("vocab_size", LLAMA.n_vocab)):
        w.add_u32(f"llama.{key}", val)
    w.add_f32("llama.rope.freq_base", LLAMA.rope_base)
    w.add_f32("llama.attention.layer_norm_rms_epsilon", LLAMA.rms_eps)
    for name, p in llama_params(jllama.LlamaConfig(**dataclasses.asdict(LLAMA)), seed=seed).items():
        w.add_tensor(name, p)
    w.write(path)
    return path


@pytest.fixture(scope="module")
def llamas(files, tmp_path_factory):  # noqa: F811
    """(JAX target, port target, JAX unrelated draft, port unrelated draft)."""
    jm, tm = _load(files, "llama")
    path = write_llama(tmp_path_factory.mktemp("spec") / "draft.gguf", seed=77)
    jd = jllama.Llama.from_gguf(path, dtype=jnp.float32, max_seq=MAX_SEQ)
    td = llama.Llama.from_gguf(path, dtype=torch.float32, max_seq=MAX_SEQ, device="cpu")
    return jm, tm, jd, td


@pytest.mark.parametrize("case", [("self", [3, 14, 15, 92], 17, 4), ("unrelated", [7, 1, 20], 13, 3),
                                  ("unrelated", [5, 6], 4, 1), ("unrelated", [5, 6], 1, 2)],
                         ids=["self-k4", "unrelated-k3", "k1-4-tokens", "1-token"])
def test_greedy_matches_jax_and_plain(llamas, case):
    jm, tm, jd, td = llamas
    which, prompt, n, k = case
    jdraft, tdraft = (jm, tm) if which == "self" else (jd, td)
    toks, rounds = speculative.speculative_generate(tm, tdraft, prompt, n, k=k)
    want, jrounds = jspec.speculative_generate(jm, jdraft, prompt, n, k=k)
    assert toks == want and rounds == jrounds, (toks, want, rounds, jrounds)
    assert toks == tm.generate(np.asarray([prompt]), n)
    if which == "self":  # a perfect draft: every round advances k + 1 tokens
        assert rounds == -(-(n - 1) // (k + 1)) + 1


def test_gptj_q4k_matches_jax():
    """bench.py's bench_spec flow at a tiny width: GPT-J (E 512, 2 layers) on
    synthesized Q4_K planes, a 1-layer self-draft over the same tensors (the
    layer-truncated draft), empty caches and token 11 at position 0, k = 3:
    the draft steps take the M = 1 GEMV and the decode attention, the
    verify's 4 rows the 2..32-row GEMV, on both sides."""
    cfg = dict(n_vocab=512, n_ctx=256, n_embd=512, n_head=4, n_layer=2, n_rot=32, rope_deinterleaved=True)
    jcfg = jgptj.GPTJConfig(**cfg)
    jparams = jgptj.synth_quantized_params(jcfg, JGGMLType.Q4_K, seed=0, dtype=jnp.float32)
    tparams = params_from_numpy(params_to_numpy(jparams), device="cpu")
    tcfg = gptj.GPTJConfig(**cfg)
    jm = jgptj.GPTJ(jparams, jcfg, max_seq=48, batch=1)
    jd = jgptj.GPTJ(jparams, dataclasses.replace(jcfg, n_layer=1), max_seq=48, batch=1)
    tm = gptj.GPTJ(tparams, tcfg, max_seq=48, batch=1, device="cpu")
    td = gptj.GPTJ(tparams, dataclasses.replace(tcfg, n_layer=1), max_seq=48, batch=1, device="cpu")
    jdec = jspec.make_speculative_decoder(jm, jd, k=3, max_new=16)
    want, jrounds, _, _ = jdec(jm.new_cache(), jd.new_cache(), jnp.int32(11), jnp.int32(0))
    dec = speculative.make_speculative_decoder(tm, td, k=3, max_new=16)
    ids, rounds, _, _ = dec(tm.new_cache(), td.new_cache(), 11, 0)
    assert ids.tolist() == np.asarray(want).tolist() and rounds == int(jrounds), (ids, want, rounds, jrounds)
    assert 1 <= dec.accepted.max() and rounds < 16  # the self-draft's first layer agrees with the target at times


def test_sampled_first_token_marginal(llamas):
    """The rejection-sampling theorem in practice (tests/test_speculative.py's
    test): the first emitted token's marginal over 400 seeds against the
    analytic warped target distribution, JAX's softmax(warp_logits) of its
    forward after prompt + [33]."""
    jm, tm, _, td = llamas
    skw = dict(temperature=1.0, top_k=12, top_p=0.92)
    prompt = np.asarray([[7, 1, 20, 9]])
    seq = np.concatenate([prompt, [[33]]], axis=1).astype(np.int32)
    lg, _ = jllama.forward(jm.params, jm.cfg, jnp.asarray(seq), jnp.zeros((1,), jnp.int32), jm.new_cache(),
                           jnp.int32(0))
    p_exact = np.asarray(jax.nn.softmax(jwarp_logits(lg[:, -1, :], **skw), axis=-1))[0]
    with torch.no_grad():
        _, tcache, t = tm.prefill(tm.new_cache(), prompt)
        _, dcache, _ = td.prefill(td.new_cache(), prompt)
    dec = speculative.make_speculative_decoder_sampled(tm, td, k=3, max_new=1, sampler=skw)
    counts = np.zeros(LLAMA.n_vocab)
    for i in range(400):  # the rows the decoder writes lie past the prompt: the caches serve every trial
        gen = torch.Generator().manual_seed(1000 + i)
        toks, rounds, _, _, _ = dec(tcache, dcache, 33, t, gen)
        assert rounds == 1
        counts[int(toks[0])] += 1
    tv = 0.5 * np.abs(counts / 400 - p_exact).sum()
    assert tv < 0.15, f"total variation {tv:.3f} from the analytic distribution"
    assert counts[p_exact < 1e-12].sum() == 0
    # a self-draft: p == q, so min(1, p / q) = 1 and every round advances k + 1
    toks, rounds = speculative.speculative_generate_sampled(tm, tm, [3, 14, 15], 12, k=3, sampler=skw, seed=5)
    assert len(toks) == 12 and all(0 <= x < LLAMA.n_vocab for x in toks) and rounds == -(-11 // 4) + 1
    assert speculative.speculative_generate_sampled(tm, td, [3, 14, 15], 12, k=3, sampler=skw, seed=5) == \
        speculative.speculative_generate_sampled(tm, td, [3, 14, 15], 12, k=3, sampler=skw, seed=5)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_paged_verify_step_matches_jax(files, family):  # noqa: F811
    """Three rows a slot: slot 0 at position 5 (page 7, offsets 1-3), slot 1
    at 11 across a page edge (page 6 offset 3, page 2 offsets 0-1), slot 2
    inactive (the trash page); the JAX step run op by op."""
    jm, tm = _load(files, family)
    cfg = tm.cfg
    n_kv = getattr(cfg, "n_head_kv", cfg.n_head)
    pcfg = dict(n_pages=9, page_size=4, max_pages_per_seq=4)
    rng = np.random.default_rng(3)
    pools = [tuple(rng.standard_normal((10, n_kv, 4, cfg.head_dim)).astype(np.float32) for _ in range(2))
             for _ in range(cfg.n_layer)]
    tables = np.array([[3, 7, 0, 0], [8, 1, 6, 2], [0, 0, 0, 0]], np.int32)
    lengths = np.array([5, 11, 0], np.int32)
    active = np.array([True, True, False])
    wpages = np.array([[7, 7, 7], [6, 2, 2], [9, 9, 9]], np.int32)
    woffs = np.array([[1, 2, 3], [3, 0, 1], [0, 0, 0]], np.int32)
    tokens = np.array([[17, 3, 90], [200, 5, 5], [0, 0, 0]], np.int32)
    jfwd, tfwd = {"gpt2": (jgpt2.forward, gpt2.forward)}.get(family, (None, None))
    with jax.disable_jit():
        jstep = jpaged.make_paged_verify_step(jm, jpaged.PagedConfig(**pcfg), forward_fn=jfwd)
        want, jpools = jstep(jm.params, tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
                             jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(tables), jnp.asarray(wpages),
                             jnp.asarray(woffs), jnp.asarray(active))
    tstep = paged_kv.make_paged_verify_step(tm, paged_kv.PagedConfig(**pcfg), forward_fn=tfwd)
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in pools]
    L = lambda a: torch.from_numpy(a).long()
    got, tpools = tstep(tm.params, tpools, L(tokens), L(lengths), L(tables), L(wpages), L(woffs),
                        torch.from_numpy(active))
    assert got.shape == (3, 3, cfg.n_vocab)
    assert nmse(np.asarray(want), got.numpy()) <= 1e-10
    assert not got[2].any()
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if family == "gpt2":
        with pytest.raises(TypeError, match="forward_fn"):
            paged_kv.make_paged_verify_step(tm, paged_kv.PagedConfig(**pcfg))
