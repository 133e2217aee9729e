"""The dense families in the port (ggml_tpu_torch.models: gemma2, which reads
gemma, gemma2 and gemma3 files, phi2, phi3, neox, falcon) against the JAX
package's, on the CPU.

- Tiny F32 files of each architecture (write_random_gguf: E 64, 4 heads,
  2-3 layers): the config equals JAX's, every tensor loads bit for bit (and
  through convert.params_from_numpy), a 20-token prefill and 4 decode steps
  within NMSE 1e-10 of JAX's jitted forward (the llama family's gate is
  1e-5), the greedy ids JAX's.  The files reach each family's own parts:
  gemma1's plain pre-norms; gemma2's sandwich, both softcaps (small enough
  to bite), a window of 6 on its even layers and query_pre_attn_scalar 24;
  gemma3's q/k norms, a window of 5 on two of every three layers, the local
  RoPE base and the global position scale 8; phi2's partial RoPE and
  biases over GQA; phi3's LongRoPE on both sides of n_ctx_orig and a
  window of 6; gptneox with the parallel and the sequential residual;
  falcon's multi-query attention and the 40B shape's dual norm over 2 kv
  heads.
- A bf16 gemma2 file: the residual stream, the norms and the logits are
  f32, the cache bf16, and the logits within NMSE 1e-5 of JAX's op by op.
- Two quantized files against JAX's forward with its Pallas kernels in
  interpret mode: gemma3 at E 768 (q, k, v, gate and up at K = 768 and
  attn_output at K = 256 are Q4_K planes multiplied out, K % 512 != 0: 12
  and 4 groups of 32 a half-plane, no GEMV tile, kernel C at every M) and
  falcon at E 160 (every 2-D weight takes llama.cpp's Q5_0 fallback: G at
  M = 1); a 20-token prefill within NMSE 1e-5, then 2 decode steps from
  JAX's cache rows.
- Finetuning: finetune and finetune_lora (dense LoRA and QLoRA) of gemma2,
  phi2, gptneox and falcon files against JAX's, losses and adapters; gemma
  and gemma3 raise JAX's ValueError.
- The registry: the seven strings resolve, the other 30 are refused.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import falcon as jfalcon
from ggml_tpu.models import gemma2 as jgemma2
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import neox as jneox
from ggml_tpu.models import phi2 as jphi2
from ggml_tpu.models import phi3 as jphi3
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import falcon, gemma2, neox, phi2, phi3, registry
from ggml_tpu_torch.quant.planar import PlanarWeight
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

T = lambda a: torch.from_numpy(np.asarray(a).copy())
MAX_SEQ = 32
SMALL = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4)
# case -> (port module, JAX module, wrapper class name, tiny config, writer arguments)
ARCHS = {
    "gemma": (gemma2, jgemma2, "Gemma2",
              gemma2.Gemma2Config(**SMALL, n_head_kv=2, head_dim=16, n_layer=2, n_ff=96, sliding_window=0,
                                  attn_softcap=0.0, final_softcap=0.0, sandwich=False, query_pre_attn_scalar=16.0),
              dict(arch="gemma")),
    "gemma2": (gemma2, jgemma2, "Gemma2",
               gemma2.Gemma2Config(**SMALL, n_head_kv=2, head_dim=16, n_layer=2, n_ff=96, sliding_window=6,
                                   attn_softcap=0.01, final_softcap=0.3, query_pre_attn_scalar=24.0),
               dict(arch="gemma2")),
    "gemma3": (gemma2, jgemma2, "Gemma2",
               gemma2.Gemma2Config(**SMALL, n_head_kv=2, head_dim=16, n_layer=3, n_ff=96, rope_base=1e6,
                                   sliding_window=5, attn_softcap=0.0, final_softcap=0.0, sliding_pattern=3,
                                   qk_norm=True, rope_local_base=10000.0, rope_scale_global=8.0,
                                   query_pre_attn_scalar=16.0), dict(arch="gemma3")),
    "phi2": (phi2, jphi2, "Phi2", phi2.Phi2Config(**SMALL, n_head_kv=2, n_layer=2, n_ff=96, n_rot=8), {}),
    "phi3": (phi3, jphi3, "Phi3",
             phi3.Phi3Config(**SMALL, n_ctx_orig=16, n_head_kv=2, head_dim=16, n_layer=2, n_ff=96, sliding_window=6,
                             longrope=True), {}),
    "gptneox": (neox, jneox, "NeoX", neox.NeoXConfig(**SMALL, n_layer=2, n_ff=96, n_rot=8), {}),
    "gptneox-sequential": (neox, jneox, "NeoX",
                           neox.NeoXConfig(**SMALL, n_layer=2, n_ff=96, n_rot=8, parallel_residual=False), {}),
    "falcon": (falcon, jfalcon, "Falcon", falcon.FalconConfig(**SMALL, n_head_kv=1, n_layer=2), {}),
    "falcon-dual-norm": (falcon, jfalcon, "Falcon",
                         falcon.FalconConfig(**SMALL, n_head_kv=2, n_layer=2, dual_norm=True), {}),
}


def write_file(path, case: str, seed: int = 0, **kw):
    mod, _, _, cfg, args = ARCHS[case]
    mod.write_random_gguf(path, cfg, seed=seed, default_type=GGMLType.F32, **dict(args, **kw))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense_families")
    return {case: write_file(d / f"{case}.gguf", case, seed=i) for i, case in enumerate(ARCHS)}


def load_both(case: str, path, max_seq: int = MAX_SEQ, keep_quantized: bool = False, dtype=torch.float32):
    """JAX's wrapper and the port's over one file, f32 by default (planes with
    keep_quantized)."""
    mod, jmod, name, _, _ = ARCHS[case]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    if keep_quantized:
        jm = getattr(jmod, name).from_gguf(str(path), dtype=jdt, keep_quantized=True, max_seq=max_seq)
    else:
        jg = JGGUFFile(str(path))
        jm = getattr(jmod, name)(jgpt2.load_params(jg, jdt), jmod.config_from_gguf(jg), max_seq=max_seq)
        jg.close()
    tm = getattr(mod, name).from_gguf(path, dtype=dtype, keep_quantized=keep_quantized, device="cpu",
                                      max_seq=max_seq)
    return jm, tm


_JIT = {}


def jax_forward(case: str):
    """JAX's forward jitted (over the F32 files equal to op by op within
    NMSE 1e-14)."""
    jmod = ARCHS[case][1]
    if jmod not in _JIT:
        _JIT[jmod] = jax.jit(jmod.forward, static_argnums=(1,))
    return _JIT[jmod]


def prompt_of(t: int, seed: int = 0):
    return np.random.default_rng(100 + seed).integers(0, SMALL["n_vocab"], (1, t)).astype(np.int32)


def prefill_and_decode(case, jm, tm, prompt, steps: int, gate: float, from_jax_rows: bool = False):
    """A prefill and `steps` greedy decode steps in both packages, each
    step's logits within `gate` (NMSE); with from_jax_rows each port step
    starts from JAX's cache rows.  Returns (the JAX ids, the NMSEs)."""
    mod, jf = ARCHS[case][0], jax_forward(case)
    t = prompt.shape[1]
    jl, jcache = jf(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32), jm.new_cache(jnp.float32),
                    jnp.int32(0))
    zero = torch.zeros((), dtype=torch.int32)
    tl, tcache = mod.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1), tm.new_cache(torch.float32), zero)
    errs = [nmse(jl, tl.numpy())]
    ids = []
    for n_past in range(t, t + steps):
        ids.append(int(np.argmax(np.asarray(jl)[0, -1])))
        if from_jax_rows:
            tcache = [(T(k), T(v)) for k, v in jcache]
        jl, jcache = jf(jm.params, jm.cfg, jnp.asarray([[ids[-1]]], jnp.int32), jnp.full((1,), n_past, jnp.int32),
                        jcache, jnp.int32(n_past))
        pos = torch.tensor(n_past, dtype=torch.int32)
        tl = mod.forward(tm.params, tm.cfg, torch.tensor([[ids[-1]]]), pos.expand(1), tcache, pos)[0]
        errs.append(nmse(jl, tl.numpy()))
    assert max(errs) <= gate, errs
    return ids + [int(np.argmax(np.asarray(jl)[0, -1]))], errs


# -- tiny F32 files -------------------------------------------------------------

@pytest.mark.parametrize("case", list(ARCHS))
def test_file_loads_and_runs_as_jax(files, case):
    jm, tm = load_both(case, files[case])
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert list(tm.params) == list(jm.params)
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, device="cpu")
    for name, p in tm.params.items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(jm.params[name]), err_msg=name)
        assert torch.equal(carried[name], p), name
    prompt = prompt_of(20, seed=len(case))
    ids, _ = prefill_and_decode(case, jm, tm, prompt, 4, 1e-10)
    assert tm.generate(prompt, 5) == ids


def test_phi3_longrope_follows_the_cache_length(files):
    """The factors and attn_factor apply for a cache of more than n_ctx_orig
    (16) rows, the short factors at 16, in both packages; the two differ."""
    last = {}
    for max_seq in (16, 24):
        jm, tm = load_both("phi3", files["phi3"], max_seq=max_seq)
        assert tm.cfg.attn_factor > 1.0
        prefill_and_decode("phi3", jm, tm, prompt_of(9, seed=1), 2, 1e-10)
        last[max_seq] = tm.prefill(tm.new_cache(torch.float32), prompt_of(9, seed=1))[0]
    assert not torch.equal(last[16], last[24])


def test_gemma_residual_is_f32_over_bf16_weights(files):
    """A bf16 load of the gemma2 file: the embedding rows times sqrt(n_embd)
    promote to f32 (as JAX's numpy f32 scalar does), so the norms, the
    residual and the logits are f32 while the cache stays bf16; a 12-token
    prefill's logits within NMSE 1e-5 of JAX's bf16 forward run op by op."""
    jm, tm = load_both("gemma2", files["gemma2"], dtype=torch.bfloat16)
    assert tm.params["token_embd.weight"].dtype == torch.bfloat16
    x = gemma2.embed(tm.params, tm.cfg, torch.tensor([[3, 4]]))
    assert x.dtype == torch.float32
    assert gemma2._rms_norm_gemma(x, tm.params["blk.0.attn_norm.weight"], 1e-6).dtype == torch.float32
    prompt = prompt_of(12, seed=3)
    zero = torch.zeros((), dtype=torch.int32)
    cache = tm.new_cache(torch.bfloat16)
    got = gemma2.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1), cache, zero)[0]
    assert got.dtype == torch.float32 and cache[0][0].dtype == torch.bfloat16
    with jax.disable_jit():
        want = jgemma2.forward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32),
                               jm.new_cache(jnp.bfloat16), jnp.int32(0))[0]
    assert want.dtype == jnp.float32
    assert nmse(want, got.numpy()) <= 1e-5


# -- quantized files, the JAX kernels in interpret mode --------------------------

@pytest.fixture(scope="module")
def quantized_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense_families_q")
    g3 = gemma2.Gemma2Config(n_vocab=256, n_ctx=64, n_embd=768, n_head=4, n_head_kv=2, head_dim=64, n_layer=1,
                             n_ff=512, sliding_window=8, attn_softcap=0.0, final_softcap=0.0, sliding_pattern=6,
                             qk_norm=True, rope_local_base=10000.0, rope_base=1e6, rope_scale_global=8.0,
                             query_pre_attn_scalar=64.0)
    gemma2.write_random_gguf(d / "gemma3-q4k.gguf", g3, seed=3, arch="gemma3",
                             types={"token_embd.weight": GGMLType.Q6_K})
    fal = falcon.FalconConfig(n_vocab=256, n_ctx=64, n_embd=160, n_head=5, n_head_kv=1, n_layer=1)
    falcon.write_random_gguf(d / "falcon-q5_0.gguf", fal, seed=4, types={"token_embd.weight": GGMLType.Q6_K})
    return {"gemma3": d / "gemma3-q4k.gguf", "falcon": d / "falcon-q5_0.gguf"}


@pytest.mark.parametrize("case", ["gemma3", "falcon"])
def test_quantized_file_matches_jax(quantized_files, case):
    """A 20-token prefill within NMSE 1e-5 (kernel C's and G's bf16
    roundings of activations flip after last-bit differences of the norms,
    tests/test_torch_llama_q4.py) and 2 decode steps from JAX's cache rows
    (1e-4: one int8 activation code of a GEMV may flip,
    tests/test_torch_deepseek.py).  gemma3: q, k, v, gate and up at K = 768
    and attn_output at K = 256 are Q4_K planes multiplied out (no compact
    planes at K % 512 != 0), whose 12 and 4 groups of 32 a half-plane fit
    no GEMV tile: C at M = 1; ffn_down at K = 512 stays compact (A).
    falcon: K = 160 and 640 are not whole superblocks: every 2-D weight is
    a Q5_0 plane (the Q6_K embedding a Q8_0 one), G at M = 1; the tied head
    is the embedding's dense copy, as in JAX."""
    jm, tm = load_both(case, quantized_files[case], max_seq=MAX_SEQ + 8, keep_quantized=True)
    p = tm.params
    if case == "gemma3":
        for name in ("blk.0.attn_q.weight", "blk.0.attn_v.weight", "blk.0.ffn_up.weight", "blk.0.attn_output.weight"):
            w = p[name]
            assert isinstance(w, PlanarWeight) and w.kind == "q4" and w.d is None, name
            assert qmatmul.select_kernel(w, 1) == "q4k_matmul", name
        assert qmatmul.select_kernel(p["blk.0.ffn_down.weight"], 1) == "q4k_gemv_qact"
    else:
        for name in ("blk.0.attn_q.weight", "blk.0.attn_k.weight", "blk.0.ffn_down.weight"):
            w = p[name]
            assert w.orig_type == GGMLType.Q5_0 and qmatmul.select_kernel(w, 1) == "q8_matmul", name
        assert p["token_embd.weight"].orig_type == GGMLType.Q8_0 and "output.weight" not in p
    _, errs = prefill_and_decode(case, jm, tm, prompt_of(20, seed=7), 2, 1e-4, from_jax_rows=True)
    assert errs[0] <= 1e-5, errs


# -- finetuning ------------------------------------------------------------------

def _tokens(n: int, seed: int = 0):
    return np.resize(np.random.default_rng(seed).integers(0, SMALL["n_vocab"], 13), n).astype(np.int32)


@pytest.mark.parametrize("case", ["gemma2", "phi2", "gptneox", "falcon"])
def test_finetune_matches_jax(files, case, tmp_path):
    """finetune: 2 AdamW steps at lr 3e-3 (batch 2 x 16) of the tiny F32
    file, losses within 1e-5 of JAX's and every trained weight within NMSE
    1e-8 but the key biases of phi2 and gptneox (a shift shared by a row's
    scores leaves the softmax alone, so their gradient is rounding noise
    that AdamW turns into +-lr steps of either sign, as
    tests/test_torch_llama_train.py finds for qwen2's); finetune_lora over the dense base, rank 4, 2 steps at lr 1e-3,
    losses within 1e-5, every `a` within NMSE 1e-9 and every `b` within
    1e-3 (b starts at zero, and AdamW's first step moves each element by lr
    times the sign of its gradient, which a gradient near zero may flip);
    the adapter loads back.  Every layer runs through common.run_layers, so
    a remat policy reaches it: the loss under nothing_saveable is the same."""
    from ggml_tpu.opt import AdamWConfig as JAdamWConfig
    from ggml_tpu.opt import finetune as jfinetune
    from ggml_tpu.opt import finetune_lora as jfinetune_lora
    from ggml_tpu_torch.gguf import GGUFFile
    from ggml_tpu_torch.opt import AdamWConfig, finetune, finetune_lora, lora
    from ggml_tpu_torch.opt.finetune import _family, make_lm_model_fn

    path, toks = str(files[case]), _tokens(200)
    kw = dict(seq_len=16, batch=2, steps=2)
    want, jopt = jfinetune(path, toks, adamw=JAdamWConfig(alpha=3e-3), **kw)
    got, opt = finetune(path, toks, adamw=AdamWConfig(alpha=3e-3), device="cpu", **kw)
    assert np.abs(np.array(want) - np.array(got)).max() <= 1e-5, (want, got)
    assert set(opt.params) == set(jopt.params)
    for name, p in opt.params.items():
        if not name.endswith("attn_k.bias"):
            assert nmse(np.asarray(jopt.params[name]), p.numpy()) <= 1e-8, name
    jl, jlora = jfinetune_lora(path, toks, rank=4, adamw=JAdamWConfig(alpha=1e-3), **kw)
    adapter = tmp_path / "adapter.gguf"
    tl, tlora = finetune_lora(path, toks, rank=4, adamw=AdamWConfig(alpha=1e-3), adapter_out=adapter, device="cpu",
                              **kw)
    assert np.abs(np.array(jl) - np.array(tl)).max() <= 1e-5, (jl, tl)
    assert set(tlora) == set(jlora) and tlora
    for name, ab in tlora.items():
        assert nmse(np.asarray(jlora[name]["a"]), ab["a"].numpy()) <= 1e-9, name
        assert nmse(np.asarray(jlora[name]["b"]), ab["b"].numpy()) <= 1e-3, name
    assert set(lora.load_lora_gguf(adapter)[0]) == set(tlora)
    fam = _family(case)
    with GGUFFile(path) as g:
        cfg = fam.config_from_gguf(g)
    x = torch.from_numpy(toks[:32].reshape(2, 16)).long()
    plain = make_lm_model_fn(fam, cfg, 16, 2)
    remat = make_lm_model_fn(fam, cfg, 16, 2, remat_policy="nothing_saveable")
    assert torch.equal(plain(opt.params, x), remat(opt.params, x))


def test_qlora_on_a_quantized_falcon_file_matches_jax(quantized_files):
    """QLoRA (keep_quantized=True) of the Q5_0 falcon file: its planes stay
    int8 and the forward runs kernel G's plain version at batch x seq = 32
    rows, gradients through planar_matmul's backward; 2 steps at lr 1e-3,
    the first loss within 3e-5 of JAX's (interpret-mode kernels), the second
    within 5e-4, every `a` within NMSE 1e-6 and every `b` within 1e-2
    (tests/test_torch_llama_train.py: bf16 roundings of activations flip
    after last-bit differences of the norms)."""
    from ggml_tpu.opt import AdamWConfig as JAdamWConfig
    from ggml_tpu.opt import finetune_lora as jfinetune_lora
    from ggml_tpu_torch.opt import AdamWConfig, finetune_lora

    path, toks = str(quantized_files["falcon"]), _tokens(100, seed=1)
    kw = dict(rank=4, keep_quantized=True, seq_len=16, batch=2, steps=2)
    jl, jlora = jfinetune_lora(path, toks, adamw=JAdamWConfig(alpha=1e-3), **kw)
    tl, tlora = finetune_lora(path, toks, adamw=AdamWConfig(alpha=1e-3), device="cpu", **kw)
    assert abs(jl[0] - tl[0]) <= 3e-5 and abs(jl[1] - tl[1]) <= 5e-4, (jl, tl)
    assert set(tlora) == set(jlora) and len(tlora) == 6  # q, k, v, attn_output, ffn_up, ffn_down
    for name, ab in tlora.items():
        assert nmse(np.asarray(jlora[name]["a"]), ab["a"].numpy()) <= 1e-6, name
        assert nmse(np.asarray(jlora[name]["b"]), ab["b"].numpy()) <= 1e-2, name


def test_finetune_refuses_gemma_and_gemma3_as_jax_does():
    from ggml_tpu.opt.finetune import _family as jfamily
    from ggml_tpu_torch.opt.finetune import _family

    for arch, mod in (("gemma2", "gemma2"), ("phi2", "phi2"), ("gptneox", "neox"), ("falcon", "falcon")):
        assert _family(arch).__name__ == f"ggml_tpu_torch.models.{mod}"
        assert jfamily(arch).__name__ == f"ggml_tpu.models.{mod}"
    for arch in ("gemma", "gemma3", "phi3"):
        with pytest.raises(ValueError, match=arch):
            _family(arch)
        with pytest.raises(ValueError, match=arch):
            jfamily(arch)


# -- the registry ----------------------------------------------------------------

def test_registry_resolves_the_seven_archs():
    for arch, cls in (("gemma", gemma2.Gemma2), ("gemma2", gemma2.Gemma2), ("gemma3", gemma2.Gemma2),
                      ("phi2", phi2.Phi2), ("phi3", phi3.Phi3), ("gptneox", neox.NeoX), ("falcon", falcon.Falcon)):
        assert registry.model_class(arch) is cls and arch not in registry._NOT_PORTED
        assert inspect.signature(cls.from_gguf).parameters["device"].default == "cuda"
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    assert len(registry._NOT_PORTED) == 30
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.model_class("bloom")
