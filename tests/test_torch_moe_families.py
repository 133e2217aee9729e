"""The other mixture-of-experts families in the port (ggml_tpu_torch.models:
glm4moe, which also reads dots1, olmoe, dbrx, phimoe, gptoss) against the
JAX package's, on the CPU.

- Tiny F32 files of the six architectures (write_random_gguf: 2-3 layers,
  E 64): the config equals JAX's, every tensor loads bit for bit (and
  through convert.params_from_numpy), a 20-token prefill (the grouped
  experts where a family has them) and 4 decode steps (the gate-masked
  sum) within NMSE 1e-10 of JAX's jitted forward, the greedy ids JAX's.
  The files reach each family's own parts: glm4moe's partial RoPE, biased
  q/k/v, a dense first layer and two groups of experts with a correction
  bias; dots1's per-head q/k norms, full RoPE and no renorm; olmoe's
  whole-width q/k norms; dbrx's clamp of q, k and v (at 0.05, where it
  cuts); phimoe's LongRoPE on both sides of n_ctx_orig; gpt-oss's sinks, a
  sliding window of 6 and YaRN.
- Two quantized files against JAX's forward with its Pallas kernels in
  interpret mode: a gpt-oss file at E 160 whose rows at K = 160 take
  llama.cpp's Q5_0 fallback (5 groups of 32: kernel G at M = 1), and a
  glm4moe Q4_K file; a 20-token prefill within NMSE 1e-5, then 2 decode
  steps from JAX's cache rows.
- Routing: sparsemixer_top2_gates against JAX's exactly on random, tied and
  threshold-edge scores; gpt-oss's grouped experts against its dense ones
  and against JAX's at 24 tokens.
- The registry: the six strings resolve, the other 30 are refused.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import dbrx as jdbrx
from ggml_tpu.models import glm4moe as jglm
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptoss as jgptoss
from ggml_tpu.models import olmoe as jolmoe
from ggml_tpu.models import phimoe as jphimoe
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import dbrx, glm4moe, gptoss, olmoe, phimoe, registry
from ggml_tpu_torch.quant.planar import PlanarWeight
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

T = lambda a: torch.from_numpy(np.asarray(a).copy())
MAX_SEQ = 32
SMALL = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4, n_head_kv=2)
# arch -> (port module, JAX module, wrapper class name, tiny config, writer arguments)
ARCHS = {
    "glm4moe": (glm4moe, jglm, "GLM4MoE",
                glm4moe.GLM4MoEConfig(**SMALL, head_dim=16, n_layer=3, n_ff=96, n_rot=8, n_expert=8, n_expert_used=3,
                                      n_group=2, topk_group=1, routed_scale=2.5), dict(n_ff_exp=24, bias_std=0.5)),
    "dots1": (glm4moe, jglm, "GLM4MoE",
              glm4moe.GLM4MoEConfig(**SMALL, head_dim=16, n_layer=2, n_ff=96, n_rot=16, qk_norm=True, n_expert=8,
                                    n_expert_used=3, moe_renorm=False, routed_scale=2.5),
              dict(n_ff_exp=24, arch="dots1", n_shared=2)),
    "olmoe": (olmoe, jolmoe, "OlmoE", olmoe.OlmoEConfig(**SMALL, n_layer=2, n_ff=32, n_expert=8, n_expert_used=3), {}),
    "dbrx": (dbrx, jdbrx, "DBRX",
             dbrx.DBRXConfig(**SMALL, n_layer=2, n_ff=32, n_expert=4, n_expert_used=2, clamp_kqv=0.05), {}),
    "phimoe": (phimoe, jphimoe, "PhiMoE",
               phimoe.PhiMoEConfig(**SMALL, n_ctx_orig=16, head_dim=16, n_layer=2, n_ff=32, n_expert=4,
                                   n_expert_used=2, longrope=True, long_mscale=1.2, short_mscale=1.1), {}),
    "gpt-oss": (gptoss, jgptoss, "GptOss",
                gptoss.GptOssConfig(**SMALL, head_dim=16, n_layer=2, n_ff=32, n_expert=4, n_expert_used=2,
                                    sliding_window=6, rope_scaling="yarn", rope_scale=4.0, n_ctx_orig=16), {}),
}


def write_file(path, arch: str, seed: int = 0, **kw):
    mod, _, _, cfg, args = ARCHS[arch]
    mod.write_random_gguf(path, cfg, seed=seed, default_type=GGMLType.F32, **dict(args, **kw))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_families")
    return {arch: write_file(d / f"{arch}.gguf", arch, seed=i) for i, arch in enumerate(ARCHS)}


def load_both(arch: str, path, max_seq: int = MAX_SEQ, keep_quantized: bool = False):
    """JAX's wrapper and the port's over one file, f32 (planes with
    keep_quantized)."""
    mod, jmod, name, _, _ = ARCHS[arch]
    if keep_quantized:
        jm = getattr(jmod, name).from_gguf(str(path), dtype=jnp.float32, keep_quantized=True, max_seq=max_seq)
    else:
        jg = JGGUFFile(str(path))
        jm = getattr(jmod, name)(jgpt2.load_params(jg, jnp.float32), jmod.config_from_gguf(jg), max_seq=max_seq)
        jg.close()
    tm = getattr(mod, name).from_gguf(path, dtype=torch.float32, keep_quantized=keep_quantized, device="cpu",
                                      max_seq=max_seq)
    return jm, tm


_JIT = {}


def jax_forward(arch: str):
    """JAX's forward jitted (over these files equal to op by op: NMSE 1e-14
    of each other and of the port)."""
    jmod = ARCHS[arch][1]
    if jmod not in _JIT:
        _JIT[jmod] = jax.jit(jmod.forward, static_argnums=(1,))
    return _JIT[jmod]


def prompt_of(t: int, seed: int = 0):
    return np.random.default_rng(100 + seed).integers(0, SMALL["n_vocab"], (1, t)).astype(np.int32)


def prefill_and_decode(arch, jm, tm, prompt, steps: int, gate: float, from_jax_rows: bool = False):
    """A prefill and `steps` greedy decode steps in both packages, each
    step's logits within `gate` (NMSE); with from_jax_rows each port step
    starts from JAX's cache rows.  Returns (the JAX ids, the NMSEs)."""
    mod, jf = ARCHS[arch][0], jax_forward(arch)
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

@pytest.mark.parametrize("arch", list(ARCHS))
def test_file_loads_and_runs_as_jax(files, arch):
    jm, tm = load_both(arch, files[arch])
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert list(tm.params) == list(jm.params)
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, device="cpu")
    for name, p in tm.params.items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(jm.params[name]), err_msg=name)
        assert torch.equal(carried[name], p), name
    prompt = prompt_of(20, seed=len(arch))
    ids, _ = prefill_and_decode(arch, jm, tm, prompt, 4, 1e-10)
    assert tm.generate(prompt, 5) == ids


def test_phimoe_longrope_follows_the_cache_length(files):
    """The factors and mscale are the short ones for a cache of n_ctx_orig
    (16) rows and the long ones above, in both packages; the two differ."""
    last = {}
    for max_seq in (16, 24):
        jm, tm = load_both("phimoe", files["phimoe"], max_seq=max_seq)
        ids, _ = prefill_and_decode("phimoe", jm, tm, prompt_of(9, seed=1), 2, 1e-10)
        last[max_seq] = (ids, tm.prefill(tm.new_cache(torch.float32), prompt_of(9, seed=1))[0])
    assert not torch.equal(last[16][1], last[24][1])


# -- quantized files, the JAX kernels in interpret mode --------------------------

@pytest.fixture(scope="module")
def quantized_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_families_q")
    oss = gptoss.GptOssConfig(n_vocab=256, n_ctx=64, n_embd=160, n_head=4, n_head_kv=2, head_dim=16, n_layer=2,
                              n_ff=64, n_expert=4, n_expert_used=2, sliding_window=8)
    gptoss.write_random_gguf(d / "gpt-oss-q5_0.gguf", oss, seed=3, types={"output.weight": GGMLType.Q6_K})
    glm = glm4moe.GLM4MoEConfig(n_vocab=256, n_ctx=64, n_embd=512, n_head=4, n_head_kv=1, head_dim=128, n_layer=2,
                                n_ff=512, n_rot=64, n_expert=4, n_expert_used=2, n_group=2, topk_group=1)
    glm4moe.write_random_gguf(d / "glm4moe-q4k.gguf", glm, seed=4, n_ff_exp=128, bias_std=0.5,
                              types={"output.weight": GGMLType.Q6_K})
    return {"gpt-oss": d / "gpt-oss-q5_0.gguf", "glm4moe": d / "glm4moe-q4k.gguf"}


@pytest.mark.parametrize("arch", ["gpt-oss", "glm4moe"])
def test_quantized_file_matches_jax(quantized_files, arch):
    """A 20-token prefill within NMSE 1e-5 (kernel C's and G's bf16
    roundings of activations flip after last-bit differences of the norms,
    tests/test_torch_llama_q4.py) and 2 decode steps from JAX's cache rows
    (1e-4: one int8 activation code of kernel A may flip,
    tests/test_torch_deepseek.py).  gpt-oss: every 2-D weight at K = 160
    (q, k, v, the router, the Q8_0 head) and attn_output at K = 64 are Q5_0
    planes whose groups (5 and 2) fit no GEMV tile: G at M = 1."""
    jm, tm = load_both(arch, quantized_files[arch], max_seq=MAX_SEQ + 8, keep_quantized=True)
    if arch == "gpt-oss":
        for name, orig in (("blk.0.attn_q.weight", GGMLType.Q5_0), ("blk.1.attn_output.weight", GGMLType.Q5_0),
                           ("output.weight", GGMLType.Q8_0)):
            w = tm.params[name]
            assert isinstance(w, PlanarWeight) and w.orig_type == orig and qmatmul.select_kernel(w, 1) == "q8_matmul"
    else:
        assert qmatmul.select_kernel(tm.params["blk.0.attn_q.weight"], 1) == "q4k_gemv_qact"
        assert tm.params["blk.1.ffn_down_shexp.weight"].orig_type == GGMLType.Q5_0
    _, errs = prefill_and_decode(arch, jm, tm, prompt_of(20, seed=7), 2, 1e-4, from_jax_rows=True)
    assert errs[0] <= 1e-5, errs


# -- routing ---------------------------------------------------------------------

def test_sparsemixer_matches_jax():
    """Random scores, rows whose maximum ties (the first wins, in both
    rounds), rows with a score exactly at the threshold and rows of equal
    scores: the same two experts a row exactly, their weights within an f32
    rounding (the two softmaxes' exp differ in the last bit)."""
    rng = np.random.default_rng(5)
    s = rng.standard_normal((2, 24, 16)).astype(np.float32)
    s[0, 0, [3, 9]] = s[0, 0].max() + 1.0  # a tied maximum
    s[0, 1, [2, 5, 11]] = s[0, 1].max() + 0.5  # three tied: round two picks the second
    s[0, 2, :] = 0.25  # all equal
    s[0, 3, :] = np.round(s[0, 3] * 4) / 4  # ties on a grid of quarters
    s[0, 4, 0], s[0, 4, 1] = 1.0, np.float32(1.0 - 0.02)  # (max - s) / max == 2 jitter at s = 0.98
    s[1, :, 7] = s[1].max() + 2.0  # one expert always first
    for jitter in (0.01, 0.3):
        want = np.asarray(jphimoe.sparsemixer_top2_gates(jnp.asarray(s), jitter))
        got = phimoe.sparsemixer_top2_gates(T(s), jitter).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
        assert ((got > 0).sum(-1) == 2).all()
    assert got[0, 0, 3] > 0 and got[0, 0, 9] > 0 and got[0, 1, 2] > 0 and got[0, 1, 5] > 0
    assert got[0, 2, 0] > 0 and got[0, 2, 1] > 0


def test_gptoss_grouped_experts_match_dense_and_jax(files, monkeypatch):
    """24 tokens through one layer's experts: the grouped products against
    the dense gate-masked sum (NMSE 1e-12) and against JAX's moe_block
    (1e-10) on each path."""
    jm, tm = load_both("gpt-oss", files["gpt-oss"])
    h = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(np.float32)
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("GGML_TPU_MOE_GROUPED", mode)
        out[mode] = gptoss.moe_block(tm.params, "blk.1.", T(h), tm.cfg).numpy()
        want = np.asarray(jgptoss.moe_block(jm.params, "blk.1.", jnp.asarray(h), jm.cfg))
        assert nmse(want, out[mode]) <= 1e-10, mode
    assert nmse(out["0"], out["1"]) <= 1e-12


# -- the registry ----------------------------------------------------------------

def test_registry_resolves_the_six_archs():
    for arch, cls in (("glm4moe", glm4moe.GLM4MoE), ("dots1", glm4moe.GLM4MoE), ("olmoe", olmoe.OlmoE),
                      ("dbrx", dbrx.DBRX), ("phimoe", phimoe.PhiMoE), ("gpt-oss", gptoss.GptOss)):
        assert registry.model_class(arch) is cls and arch not in registry._NOT_PORTED
        assert inspect.signature(cls.from_gguf).parameters["device"].default == "cuda"
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    assert len(registry._NOT_PORTED) == 30  # 37 before the dense families (tests/test_torch_dense_families.py)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.model_class("jetmoe")
