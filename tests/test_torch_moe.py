"""The llama family's mixture-of-experts block in the port
(ggml_tpu_torch.models.llama: moe_topk, moe_gates, moe_expert_sum,
moe_expert_sum_grouped, moe_ffn_block) against the JAX package's, on the
CPU, and the MoE models through the port's paths: GGUF files of Mixtral
(a llama file with experts), qwen2moe (q/k/v biases, the sigmoid-gated
shared expert, top-k probabilities not renormalized), qwen3moe (per-head
q/k norms, a decoupled head_dim) and granitemoe (the four scales).

- The functions on numpy-seeded inputs (6 experts, 2 a token, 18 tokens)
  whose router logits sit on a grid of quarters, so that most rows hold
  ties, one of them at the k-th place: the chosen experts equal JAX's
  (jax.lax.top_k puts the lower expert first among equals), the weights,
  gates and both expert sums within NMSE 1e-12 (f32 sums in another order),
  grouped against dense within 1e-12, and the grouped sum's gradients in h
  and the three expert stacks against jax.grad's within 1e-10.  Ties again
  with bf16-rounded logits over 128 experts, 8 a token.  moe_ffn_block under
  GGML_TPU_MOE_GROUPED auto (18 tokens: grouped; 5 tokens: dense), 1 and 0.
- Tiny f32 files (E 64, 4 heads over 2 kv heads, 2 layers, 4 experts of
  width 32, 2 a token; write_random_gguf): the config equals JAX's, every
  tensor loads bit for bit as JAX's load_params does, a 20-token prefill
  (the grouped path) and 2 teacher-forced decode steps (dense) against the
  JAX forward run op by op within NMSE 1e-10, and the port's greedy decode
  gives JAX's greedy ids.
- A tiny Q4_K qwen3moe file (E 256, one layer, a Q6_K head, Q4_K and Q6_K
  experts dequantized at load): a 20-token prefill (kernel B's plain version
  on the planes, the grouped experts) and 2 decode steps (A) against JAX's
  forward with its Pallas kernels in interpret mode
  (test_torch_gptj_q8.assert_same_choice).
- quant/torch_dequant.py (the card's decode of a load's experts) bit for
  bit reference.dequantize's Q4_K, Q5_0 and Q8_0 values.
- load_params dequantizes a 3-D expert tensor in chunks of experts: the
  result equals the whole tensor's and JAX's load_params bit for bit; it
  repacks a large 2-D weight's planes in chunks of rows: every plane equals
  the whole weight's.
- The paged step of a qwen2moe file against JAX's (dense and grouped
  experts); the Engine against JAX's Engine, dense at 16 slots (each tick
  takes the grouped path, as JAX's does) and paged with the prefix cache.
- Finetuning a tiny qwen3moe file (the experts' gradients through the
  grouped path): full weights and LoRA against JAX's finetune and
  finetune_lora; rematerialization recomputes the grouped products as
  jax.checkpoint recomputes ragged_dot_general (the dots policies save no
  ragged_dot_general), the gradients equal without it.  The same entry
  points with the experts in bf16, as they train on the card.
- generate on a qwen3moe file with a vocabulary: the JAX CLI's text.
"""

import dataclasses
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore
from torch.utils._python_dispatch import TorchDispatchMode

from ggml_tpu import paged_kv as jpaged
from ggml_tpu.cli import generate as jcli
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import llama as jllama
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import finetune as jax_finetune
from ggml_tpu.opt import finetune_lora as jax_finetune_lora
from ggml_tpu.opt.finetune import make_lm_model_fn as jax_make_lm_model_fn
from ggml_tpu.opt.optimizer import LOSS_TYPES as JAX_LOSS_TYPES
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.models import gpt2, llama, registry
from ggml_tpu_torch.opt import AdamWConfig, finetune, finetune_lora, make_lm_model_fn
from ggml_tpu_torch.opt.optimizer import LOSS_TYPES
from ggml_tpu_torch.serve import Engine
from tests.test_torch_gptj_q8 import assert_same_choice
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

E, FF, D, K = 6, 24, 16, 2
ARCHS = {  # arch -> config changes
    "llama": {},
    "qwen2moe": {},
    "qwen3moe": dict(head_dim_override=32),
    "granitemoe": dict(embd_scale=12.0, resid_scale=0.22, attn_scale=0.0625, logit_scale=8.0),
}
TINY = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4, n_head_kv=2, n_layer=2, n_ff=96, rope_base=10000.0,
            n_expert=4, n_expert_used=2)
MAX_SEQ = 32


def _block_inputs(seed: int = 7, b: int = 2, t: int = 9):
    """h (b, t, D), router logits on a grid of quarters (ties in most rows;
    row 0 ties at the k-th place), the three expert stacks."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, t, D)).astype(np.float32)
    router = (np.round(rng.standard_normal((b, t, E)) * 4) / 4).astype(np.float32)
    router[0, 0] = [1.0, 0.5, -1.0, 0.5, 0.5, 0.0]
    w = [(rng.standard_normal(s) * 0.2).astype(np.float32) for s in ((E, FF, D), (E, FF, D), (E, D, FF))]
    return h, router, w


T = lambda a: torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "qwen2moe"])
def test_functions_match_jax(renorm):
    h, router, (wg, wu, wd) = _block_inputs()
    top = np.sort(router, axis=-1)[..., ::-1]
    assert (top[..., K - 1] == top[..., K]).sum() >= 3  # ties at the k-th place
    jp, ji = jllama.moe_topk(jnp.asarray(router), K, renorm)
    tp, ti = llama.moe_topk(T(router), K, renorm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0, 0].tolist() == [0, 1]
    assert nmse(jp, tp.numpy()) <= 1e-12
    if not renorm:
        assert float(tp.sum(-1).max()) < 0.999  # the k weights of the full softmax do not sum to 1
    jg = jllama.moe_gates(jnp.asarray(router), E, K, renorm)
    tg = llama.moe_gates(T(router), E, K, renorm)
    assert nmse(jg, tg.numpy()) <= 1e-12
    jdense = jllama.moe_expert_sum(jnp.asarray(h), *map(jnp.asarray, (wg, wu, wd)), jg)
    tdense = llama.moe_expert_sum(T(h), T(wg), T(wu), T(wd), tg)
    assert nmse(jdense, tdense.numpy()) <= 1e-12

    def jgrouped(h, wg, wu, wd):
        return jllama.moe_expert_sum_grouped(h, wg, wu, wd, jp, ji, E)

    jgr = jgrouped(*map(jnp.asarray, (h, wg, wu, wd)))
    leaves = [T(a).requires_grad_() for a in (h, wg, wu, wd)]
    tgr = llama.moe_expert_sum_grouped(*leaves, tp, ti, E)
    assert nmse(jgr, tgr.detach().numpy()) <= 1e-12 and nmse(tdense, tgr.detach().numpy()) <= 1e-12
    jgrads = jax.grad(lambda *a: jgrouped(*a).sum(), argnums=(0, 1, 2, 3))(*map(jnp.asarray, (h, wg, wu, wd)))
    tgrads = torch.autograd.grad(tgr.sum(), leaves)  # an expanded gradient: _ContiguousGrad hands on a whole one
    for j, t in zip(jgrads, tgrads):
        assert nmse(j, t.numpy()) <= 1e-10


def test_ties_over_128_experts_pick_jax_s():
    """bf16-rounded router logits of 512 tokens over 128 experts, 8 a token
    (Qwen3-30B-A3B's router): dozens of rows tie at the 8th place; one row
    all zeros, half of them -0.0 (jax.lax.top_k ranks 0.0 above -0.0)."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32)).bfloat16().float().numpy()
    logits[0] = 0.0
    logits[0, ::2] = -0.0
    top = np.sort(logits, axis=-1)[:, ::-1]
    assert (top[:, 7] == top[:, 8]).sum() >= 20
    for renorm in (True, False):
        _, ji = jllama.moe_topk(jnp.asarray(logits), 8, renorm)
        np.testing.assert_array_equal(llama.moe_topk(T(logits), 8, renorm)[1].numpy(), np.asarray(ji))


def _block_params(seed: int = 8):
    """One layer's MoE params with qwen2moe's shared expert."""
    _, _, (wg, wu, wd) = _block_inputs(seed)
    rng = np.random.default_rng(seed)
    p = {"ffn_gate_exps.weight": wg, "ffn_up_exps.weight": wu, "ffn_down_exps.weight": wd,
         "ffn_gate_inp.weight": (rng.standard_normal((E, D)) * 0.5).astype(np.float32),
         "ffn_gate_inp_shexp.weight": (rng.standard_normal((1, D)) * 0.5).astype(np.float32)}
    for name, shape in (("ffn_gate_shexp", (FF, D)), ("ffn_up_shexp", (FF, D)), ("ffn_down_shexp", (D, FF))):
        p[name + ".weight"] = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    return p


@pytest.mark.parametrize("mode,t", [("auto", 9), ("auto", 5), ("1", 5), ("0", 9)],
                         ids=["auto-grouped", "auto-dense", "grouped", "dense"])
def test_moe_ffn_block_matches_jax(mode, t, monkeypatch):
    """The block with qwen2moe's shared expert on b x t tokens (b = 2 at t =
    9: 18 tokens, b = 1 at t = 5), the path chosen by GGML_TPU_MOE_GROUPED
    on both sides: NMSE <= 1e-12."""
    monkeypatch.setenv("GGML_TPU_MOE_GROUPED", mode)
    h = _block_inputs(b=2 if t == 9 else 1, t=t)[0]
    p = _block_params()
    cfg = dict(n_embd=D, n_expert=E, n_expert_used=K, moe_renorm=False, moe_shared=True)
    want = jllama.moe_ffn_block({k: jnp.asarray(v) for k, v in p.items()}, "", jnp.asarray(h),
                                jllama.LlamaConfig(**cfg))
    got = llama.moe_ffn_block({k: T(v) for k, v in p.items()}, "", T(h), llama.LlamaConfig(**cfg))
    assert nmse(want, got.numpy()) <= 1e-12


def _write(path, arch: str, seed: int = 0, **changes):
    cfg = llama.LlamaConfig(**dict(TINY, **ARCHS[arch], **changes))
    llama.write_random_gguf(path, cfg, seed=seed, arch=arch, n_ff_exp=32, default_type=GGMLType.F32)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    return {arch: _write(d / f"{arch}.gguf", arch, seed=i) for i, arch in enumerate(ARCHS)}


def _models(path, max_seq: int = MAX_SEQ):
    jg = JGGUFFile(str(path))
    jm = jllama.Llama(jgpt2.load_params(jg, jnp.float32), jllama.config_from_gguf(jg), max_seq=max_seq)
    jg.close()
    tm = llama.Llama.from_gguf(path, dtype=torch.float32, keep_quantized=False, device="cpu", max_seq=max_seq)
    return jm, tm


def _prompt(t: int, seed: int = 0):
    return np.random.default_rng(100 + seed).integers(0, TINY["n_vocab"], (1, t)).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_file_loads_and_runs_as_jax(files, arch):
    jm, tm = _models(files[arch])
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg) and tm.cfg.n_expert == 4
    assert registry.model_class(arch) is llama.Llama
    assert list(tm.params) == list(jm.params)
    for name, p in tm.params.items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(jm.params[name]), err_msg=name)
    assert tm.params["blk.1.ffn_down_exps.weight"].shape == (4, 64, 32)
    prompt = _prompt(20)
    jl, jcache = jllama.forward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32),
                                jm.new_cache(jnp.float32), jnp.int32(0), prefill=True)
    zero = torch.zeros((), dtype=torch.int32)
    tl, tcache = llama.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1), tm.new_cache(torch.float32), zero,
                               prefill=True)
    assert nmse(jl, tl.numpy()) <= 1e-10, nmse(jl, tl.numpy())
    ids = []
    for n_past in range(20, 22):
        ids.append(int(np.argmax(np.asarray(jl)[0, -1])))
        jl, jcache = jllama.forward(jm.params, jm.cfg, jnp.asarray([[ids[-1]]], jnp.int32),
                                    jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
        pos = torch.tensor(n_past, dtype=torch.int32)
        tl = llama.forward(tm.params, tm.cfg, torch.tensor([[ids[-1]]]), pos.expand(1), tcache, pos)[0]
        assert nmse(jl, tl.numpy()) <= 1e-10, (n_past, nmse(jl, tl.numpy()))
    ids.append(int(np.argmax(np.asarray(jl)[0, -1])))
    assert tm.generate(prompt, 3) == ids


@pytest.fixture(scope="module")
def q4k_file(tmp_path_factory):
    """A tiny qwen3moe of Q4_K weights, a Q6_K head and Q6_K ffn_down experts."""
    cfg = llama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_head_kv=2, n_layer=1, n_ff=512,
                            rope_base=1e6, rms_eps=1e-6, head_dim_override=64, n_expert=4, n_expert_used=2)
    path = tmp_path_factory.mktemp("moe_q4k") / "qwen3moe-q4k.gguf"
    llama.write_random_gguf(path, cfg, seed=4, arch="qwen3moe", n_ff_exp=256,
                            types={"output.weight": GGMLType.Q6_K, "blk.0.ffn_down_exps.weight": GGMLType.Q6_K})
    return path


def test_q4k_qwen3moe_matches_jax(q4k_file):
    jm = jllama.Llama.from_gguf(str(q4k_file), dtype=jnp.float32, keep_quantized=True, max_seq=MAX_SEQ)
    tm = llama.Llama.from_gguf(q4k_file, dtype=torch.float32, device="cpu", max_seq=MAX_SEQ)
    assert tm.cfg.qk_norm and tm.params["blk.0.ffn_up_exps.weight"].shape == (4, 256, 256)
    prompt = _prompt(20, seed=1)
    jl, jcache = jllama.forward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32),
                                jm.new_cache(jnp.float32), jnp.int32(0), prefill=True)
    zero = torch.zeros((), dtype=torch.int32)
    tl, tcache = llama.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1), tm.new_cache(torch.float32), zero,
                               prefill=True)
    assert_same_choice(jl, tl.numpy(), "prefill")
    for n_past in (20, 21):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        jl, jcache = jllama.forward(jm.params, jm.cfg, jnp.asarray([[tok]], jnp.int32),
                                    jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
        pos = torch.tensor(n_past, dtype=torch.int32)
        tl = llama.forward(tm.params, tm.cfg, torch.tensor([[tok]]), pos.expand(1), tcache, pos)[0]
        assert_same_choice(jl, tl.numpy(), n_past)


def test_load_params_chunks_experts(q4k_file, monkeypatch):
    """Chunks of at most 96 rows, and of whole experts, at least one: each
    expert stack (4 experts of 256 rows) in 4 jobs, the 256-row embedding
    and head in 3; bf16, as the card loads them: bit for bit the whole
    tensors' and JAX's."""
    jg = JGGUFFile(str(q4k_file))
    want = jgpt2.load_params(jg, jnp.bfloat16)
    jg.close()
    with GGUFFile(q4k_file) as g:
        whole = gpt2.load_params(g, torch.bfloat16, device="cpu")
        monkeypatch.setattr(gpt2, "_CHUNK_ROWS", 96)
        jobs = []
        real = gpt2._dequantize_rows
        monkeypatch.setattr(gpt2, "_dequantize_rows", lambda *a: jobs.append(a[1]) or real(*a))
        chunked = gpt2.load_params(g, torch.bfloat16, device="cpu")
    assert jobs.count("blk.0.ffn_gate_exps.weight") == 4 and jobs.count("blk.0.ffn_down_exps.weight") == 4
    bits = lambda x: x.view(torch.int16).numpy()
    for name in ("blk.0.ffn_gate_exps.weight", "blk.0.ffn_up_exps.weight", "blk.0.ffn_down_exps.weight",
                 "token_embd.weight", "output.weight"):
        np.testing.assert_array_equal(bits(chunked[name]), bits(whole[name]), err_msg=name)
        np.testing.assert_array_equal(bits(chunked[name]), np.asarray(want[name]).view(np.int16), err_msg=name)


@pytest.mark.parametrize("t", ["Q4_K", "Q5_0", "Q8_0"])
def test_torch_dequant_equals_the_reference(t):
    """quant/torch_dequant.py, which decodes a CUDA load's experts on the
    card, run here on CPU tensors: bit for bit reference.dequantize's values
    over random blocks whose fp16 fields take every finite bit pattern
    class (subnormals, the largest, negative, zero)."""
    from ggml_tpu_torch.dtypes import get_type_traits
    from ggml_tpu_torch.quant import reference, torch_dequant

    t = GGMLType[t]
    tr = get_type_traits(t)
    rng = np.random.default_rng(11)
    b = reference.random_blocks(t, 2048, rng)
    offs = {GGMLType.Q4_K: (0, 2), GGMLType.Q5_0: (0,), GGMLType.Q8_0: (0,)}[t]
    for off in offs:
        bits = rng.integers(0, 0x7C00, 2048, dtype=np.uint16) | (rng.integers(0, 2, 2048, dtype=np.uint16) << 15)
        bits[:4] = [0x0001, 0x7BFF, 0x8000, 0x0000]
        b[:, off:off + 2] = bits.astype("<u2").view(np.uint8).reshape(2048, 2)
    n = 2048 * tr.block_size
    want = reference.dequantize(b, t, n)
    got = torch_dequant.dequantize(torch.from_numpy(b), t, n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [300, 4500])
def test_load_params_chunks_planes(tmp_path, monkeypatch, n):
    """A 2-D weight of more than _CHUNK_ROWS rows (Qwen3-30B-A3B's head
    holds 151936) is repacked in chunks of whole padding units, a job each,
    the last ragged, and its planes put side by side: every plane bit for
    bit the whole weight's, for compact Q4_K and Q6_K, Q8_0 and Q4_0
    planes; 4500 rows pad to 1024s (5120, 5 chunks, the last of 404 rows
    padded as the whole pads), 300 to 128s (384, 3)."""
    from ggml_tpu_torch.dtypes import get_type_traits
    from ggml_tpu_torch.gguf import GGUFWriter
    from ggml_tpu_torch.quant import planar
    from ggml_tpu_torch.quant.reference import random_blocks

    rng = np.random.default_rng(3)
    types = (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, GGMLType.Q4_0)
    w = GGUFWriter()
    w.add_string("general.architecture", "llama")
    for t in types:
        w.add_tensor(f"{t.name}.weight", random_blocks(t, n * 512 // get_type_traits(t).block_size, rng), t,
                     raw_shape_ne=(512, n))
    w.write(tmp_path / "planes.gguf")
    with GGUFFile(tmp_path / "planes.gguf") as g:
        whole = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cpu")
        monkeypatch.setattr(gpt2, "_CHUNK_ROWS", n // 3)
        starts = []
        real = planar.repack_rows
        monkeypatch.setattr(planar, "repack_rows", lambda *a: starts.append((a[1], a[3])) or real(*a))
        chunked = gpt2.load_params(g, torch.float32, keep_quantized=True, device="cpu")
    step = 1024 if n == 4500 else 128
    # the jobs run on the loader's threads: each type's chunks, in any order
    assert sorted(starts) == sorted((t, r) for t in types for r in range(0, n, step))
    for t in types:
        a, b = whole[f"{t.name}.weight"], chunked[f"{t.name}.weight"]
        assert isinstance(b, planar.PlanarWeight) and (b.n, b.k, b.npad, b.kind) == (a.n, a.k, a.npad, a.kind)
        assert b.npad == -(-n // step) * step
        for name in ("codes", "scales", "offsets", "d", "dmin"):
            pa, pb = getattr(a, name), getattr(b, name)
            assert (pa is None and pb is None) or torch.equal(pa, pb), (t.name, name)


@pytest.mark.parametrize("mode", ["auto", "1"], ids=["dense-experts", "grouped-experts"])
def test_paged_step_matches_jax(files, mode, monkeypatch):
    """tests/test_torch_paged.py's slots (positions 5 and 11, an inactive
    third) through a qwen2moe file: logits NMSE <= 1e-10, pools within
    1e-5; three tokens take the dense experts, GGML_TPU_MOE_GROUPED=1 the
    grouped ones."""
    monkeypatch.setenv("GGML_TPU_MOE_GROUPED", mode)
    jm, tm = _models(files["qwen2moe"])
    cfg = tm.cfg
    pcfg = dict(n_pages=9, page_size=4, max_pages_per_seq=4)
    rng = np.random.default_rng(3)
    pools = [tuple(rng.standard_normal((10, cfg.n_head_kv, 4, cfg.head_dim)).astype(np.float32) for _ in range(2))
             for _ in range(cfg.n_layer)]
    tables = np.array([[3, 7, 0, 0], [8, 1, 6, 2], [0, 0, 0, 0]], np.int32)
    args = [np.array([[17], [200], [0]], np.int32), np.array([5, 11, 0], np.int32), tables,
            np.array([7, 6, 9], np.int32), np.array([1, 3, 0], np.int32)]
    active = np.array([True, True, False])
    with jax.disable_jit():
        jstep = jpaged.make_paged_decode_step(jm, jpaged.PagedConfig(**pcfg))
        want, jpools = jstep(jm.params, tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
                             *map(jnp.asarray, args), jnp.asarray(active))
    tstep = paged_kv.make_paged_decode_step(tm, paged_kv.PagedConfig(**pcfg))
    tpools = [(T(k), T(v)) for k, v in pools]
    got, tpools = tstep(tm.params, tpools, *(T(a).long() for a in args), T(active))
    assert nmse(np.asarray(want), got.numpy()) <= 1e-10
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=4)
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind", ["dense-16-slots", "paged-prefix-cache"])
def test_engine_matches_jax(files, kind):
    """A Mixtral file.  Dense: 16 slots, so that every tick's 16 rows take
    the grouped experts on both sides.  Paged: 2 slots, pages of 4 with the
    prefix cache, a warm request first.  The same ids as JAX's engine and
    as each request alone."""
    jm, tm = _models(files["llama"])
    rng = np.random.default_rng(4)
    common = [int(x) for x in rng.integers(1, 255, 9)]
    prompts = [common + [3], [9, 9, 1], common + [4, 8]]
    if kind == "dense-16-slots":
        mk = lambda m, dt, eng_cls: eng_cls(m, max_batch=16, max_seq=MAX_SEQ, cache_dtype=dt)
    else:
        mk = lambda m, dt, eng_cls: eng_cls(
            m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=dt, horizon=4,
            paged=(jpaged if eng_cls is JEngine else paged_kv).PagedConfig(
                n_pages=20, page_size=4, max_pages_per_seq=8, prefix_cache=True))
    jeng, teng = mk(jm, jnp.float32, JEngine), mk(tm, torch.float32, Engine)
    if kind != "dense-16-slots":
        for eng in (jeng, teng):
            _run(eng, [common + [2]], 3)
    want = _run(jeng, prompts, 6)
    assert _run(teng, prompts, 6) == want
    assert [tm.generate(np.asarray([p]), 6) for p in prompts] == want
    if kind != "dense-16-slots":
        assert teng.cached_prefix_tokens == jeng.cached_prefix_tokens > 0


def _pattern(n):
    return np.asarray(([7, 11, 23, 42, 5, 99, 3] * (n // 7 + 1))[:n], np.int32)


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_qwen3moe_finetune_matches_jax(files, kind):
    """3 AdamW steps of batch 2 x 16 (32 tokens: the grouped experts), as
    tests/test_torch_llama_train.py holds the dense family: full weights
    (losses within 1e-5, every trained tensor, the experts' too, within
    NMSE 1e-8) and LoRA on the default targets (losses within 1e-5, every
    adapter a within 1e-9 and b within 1e-3)."""
    path, toks = str(files["qwen3moe"]), _pattern(300)
    kw = dict(seq_len=16, batch=2, steps=3)
    if kind == "full":
        want, jopt = jax_finetune(path, toks, adamw=JaxAdamWConfig(alpha=3e-3), **kw)
        got, opt = finetune(path, toks, adamw=AdamWConfig(alpha=3e-3), device="cpu", **kw)
        trained, jtrained = opt.params, jopt.params
        assert trained["blk.0.ffn_down_exps.weight"].shape == (4, 64, 32)
        gate = {"": 1e-8}
    else:
        want, jtrained = jax_finetune_lora(path, toks, rank=4, adamw=JaxAdamWConfig(alpha=1e-3), **kw)
        got, trained = finetune_lora(path, toks, rank=4, adamw=AdamWConfig(alpha=1e-3), device="cpu", **kw)
        assert len(trained) == 4 * TINY["n_layer"]  # q, k, v, attn_output: the experts are 3-D
        trained = {f"{n}/{ab}": t[ab] for n, t in trained.items() for ab in "ab"}
        jtrained = {f"{n}/{ab}": t[ab] for n, t in jtrained.items() for ab in "ab"}
        gate = {"/a": 1e-9, "/b": 1e-3}
    assert np.abs(np.array(want) - np.array(got)).max() <= 1e-5, (want, got)
    assert got[-1] < got[0] and set(trained) == set(jtrained)
    for name, p in trained.items():
        g = next(v for k, v in gate.items() if name.endswith(k))
        assert nmse(np.asarray(jtrained[name]), p.detach().numpy()) <= g, name


def ragged_dots(jaxpr) -> int:
    """ragged_dot_general equations in a jaxpr and every jaxpr inside it."""
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "ragged_dot_general"
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    n += ragged_dots(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    n += ragged_dots(sub)
    return n


class _GroupedCount(TorchDispatchMode):
    """Counts aten._grouped_mm calls, the backward's included, and records
    the types of their two operands."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.types = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._grouped_mm.default:
            self.n += 1
            self.types.add((args[0].dtype, args[1].dtype))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_qwen3moe_finetune_with_bf16_experts_as_on_the_card(files, kind, monkeypatch):
    """On the card the grouped expert product takes bf16 only
    (llama.grouped_matmul), so there the entry points train a
    mixture-of-experts model's experts in bf16 (finetune.moe_expert_dtype):
    finetune casts its f32 master experts in the forward, finetune_lora
    loads its frozen experts in bf16.  That choice forced on the CPU, 2
    steps of batch 2 x 16: every grouped product, the backward's included,
    takes bf16 operands, finetune's trained experts stay f32, and the losses
    are within 1e-2 of the f32 run's (read: 1e-3 full, 5e-6 LoRA)."""
    ft = importlib.import_module("ggml_tpu_torch.opt.finetune")
    assert ft.moe_expert_dtype("cuda") == torch.bfloat16 and ft.moe_expert_dtype("cpu") is None
    path, toks = str(files["qwen3moe"]), _pattern(300)
    kw = dict(seq_len=16, batch=2, steps=2, device="cpu")
    if kind == "full":
        run = lambda: finetune(path, toks, adamw=AdamWConfig(alpha=3e-3), **kw)
    else:
        run = lambda: finetune_lora(path, toks, rank=4, adamw=AdamWConfig(alpha=1e-3), **kw)
    want, _ = run()
    monkeypatch.setattr(ft, "moe_expert_dtype", lambda device: torch.bfloat16)
    with _GroupedCount() as count:
        got, trained = run()
    per_layer = 9 if kind == "full" else 6  # 3 forward, and 6 or (frozen experts) 3 backward
    assert count.n == 2 * per_layer * TINY["n_layer"] and count.types == {(torch.bfloat16, torch.bfloat16)}, (
        count.n, count.types)
    if kind == "full":
        assert trained.params["blk.0.ffn_gate_exps.weight"].dtype == torch.float32
    assert np.abs(np.array(want) - np.array(got)).max() <= 1e-2, (want, got)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable"])
def test_remat_recomputes_the_grouped_products_as_jax(files, policy):
    """A forward and backward of the tiny qwen3moe at 2 x 16 tokens: as many
    grouped products as JAX's make_jaxpr of the remat'd value_and_grad holds
    ragged_dot_general equations (3 a layer forward, 3 recomputed, 6 in the
    backward), gradients equal to those without remat bit for bit."""
    with GGUFFile(files["qwen3moe"]) as g:
        params = gpt2.load_params(g, torch.float32, device="cpu")
        cfg = llama.config_from_gguf(g)
    jg = JGGUFFile(str(files["qwen3moe"]))
    jparams, jcfg = jgpt2.load_params(jg, jnp.float32), jllama.config_from_gguf(jg)
    jg.close()
    x = _pattern(32).reshape(2, 16)
    jfn = jax_make_lm_model_fn(jllama, jcfg, 16, 2, remat_policy=policy)
    jloss = lambda p: JAX_LOSS_TYPES["cross_entropy_sparse"](jfn(p, jnp.asarray(x)), jnp.asarray(x))
    want = ragged_dots(jax.make_jaxpr(jax.value_and_grad(jloss))(jparams).jaxpr)
    grads = {}
    for pol in (None, policy):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        with _GroupedCount() as count:
            tx = T(x).long()
            loss = LOSS_TYPES["cross_entropy_sparse"](make_lm_model_fn(llama, cfg, 16, 2, remat_policy=pol)(
                leaves, tx), tx)
            grads[pol] = torch.autograd.grad(loss, list(leaves.values()))
        if pol is not None:
            assert count.n == want == 12 * cfg.n_layer, (count.n, want)
    assert all(torch.equal(a, b) for a, b in zip(grads[None], grads[policy]))


def test_generate_on_a_qwen3moe_file_is_the_jax_cli_text(tmp_path, monkeypatch, capsys):
    """A qwen3moe file with a 256-entry vocabulary of byte tokens ids:
    the CLI's greedy text, dense f32, as JAX's CLI prints it."""
    path = tmp_path / "qwen3moe-vocab.gguf"
    cfg = llama.LlamaConfig(**dict(TINY, **ARCHS["qwen3moe"]))
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens[1], tokens[2] = "<s>", "</s>"
    for i, word in enumerate(("▁hello", "▁moe", "▁experts", "▁route", "▁tokens"), start=200):
        tokens[i] = word
    llama.write_random_gguf(path, cfg, seed=9, arch="qwen3moe", n_ff_exp=32, default_type=GGMLType.F32,
                            tokenizer=dict(model="llama", tokens=tokens, scores=[0.0] * 256, bos_token_id=1,
                                           eos_token_id=2))
    argv = [str(path), "-p", "hello moe experts", "-n", "6", "--top-k", "1", "--seed", "0"]
    monkeypatch.setattr(sys, "argv", ["generate"] + argv)
    jcli.main()
    want = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello moe experts"), (got, want)
