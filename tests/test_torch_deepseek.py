"""The DeepSeek V2/V3 family in the port (ggml_tpu_torch.models.deepseek:
absorbed multi-head latent attention, group-limited routing, shared
experts, leading dense layers) against the JAX package's, on the CPU.

- deepseek_route on numpy-seeded hidden rows that pick one router column
  each, so the logits are the router's values exactly: values on a grid of
  quarters tie inside groups, between group scores and at the k-th place;
  biases of -1.75..0 let experts of masked groups (0.0) outrank surviving
  ones.  softmax and sigmoid, 1 group and 4 groups of which 2 survive,
  renormalized or not: the chosen experts equal JAX's, the weights within
  NMSE 1e-12.
- Tiny f32 deepseek2 files (write_random_gguf: E 64, 4 heads, 3 layers, the
  first dense, 8 experts of 24, 3 a token) of four kinds: q_lora 0 and 48,
  interleaved rope dims or not, softmax scores, sigmoid scores with a bias
  and 4 groups.  The config equals JAX's, every tensor loads bit for bit
  (and through convert.params_from_numpy), prefills of 20 tokens (the
  grouped experts) and 8 (dense) and 2 decode steps within NMSE 1e-10 of
  the JAX forward, the port's greedy ids JAX's.
- A Q4_K file whose dense ffn_down has K = 768 (K/2/32 = 12 groups: kernel
  C's plain version at M = 1 in both packages) and a Q6_K head: a 40-token
  prefill (NMSE 1e-5, as tests/test_torch_llama_q4.py gates C's prefill)
  and 2 decode steps from JAX's cache rows (bit for bit but where one int8
  activation code of kernel A flips: 1e-4), three prompts, against JAX's
  forward with its Pallas kernels in interpret mode; the kernel selection
  report shows C in the GEMV class at K = 768.
- The q8 latent cache: codes and scales as JAX writes them, the engine's ids
  with a q8 cache as JAX's engine gives them.
- The MLA paged step against JAX's _make_paged_step_deepseek (NMSE 1e-10).
- The Engine against JAX's Engine on one file: dense (2 slots), paged with
  the prefix cache, chunked; page-pressure eviction through host snapshots
  of the latent pages, priority preemption and greedy forks as each request
  alone; a 2-layer self-draft on the dense engine gives
  the plain engine's ids (JAX's engine takes no Deepseek draft); paged plus
  draft raises in both packages.
- Finetuning: full weights and LoRA against JAX's finetune and
  finetune_lora, step by step; QLoRA over a file whose attn_kv_b is
  quantized fails in both packages where the forward reshapes it, over one
  whose attn_kv_b is F32 both run and agree.
- The finetune CLI on a deepseek2 file (full and LoRA); generate on a
  deepseek2 file with a vocabulary: the JAX CLI's text.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu.cli import generate as jcli
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import deepseek as jds
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models.common import QuantKV as JQuantKV
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import finetune as jax_finetune
from ggml_tpu.opt import finetune_lora as jax_finetune_lora
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.convert import params_from_numpy
from ggml_tpu_torch.dtypes import GGMLType
from ggml_tpu_torch.kernels import qmatmul
from ggml_tpu_torch.models import deepseek, registry
from ggml_tpu_torch.models.common import QuantKV
from ggml_tpu_torch.opt import AdamWConfig, finetune, finetune_lora
from ggml_tpu_torch.serve import Engine
from tests.test_torch_rules import nmse, one_thread, planar_fields  # noqa: F401  (the autouse fixture)

T = lambda a: torch.from_numpy(np.asarray(a).copy())
TINY = dict(n_vocab=256, n_ctx=64, n_embd=64, n_head=4, n_layer=3, n_ff=96, n_dense_lead=1, kv_lora_rank=32,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=12, n_expert=8, n_expert_used=3, n_shared=2)
KINDS = {  # kind -> (config changes, bias std)
    "q0-interleaved-softmax": (dict(score_func="softmax", moe_renorm=False), 0.0),
    "q48-plain-sigmoid-groups": (dict(q_lora_rank=48, rope_interleave=False, score_func="sigmoid", n_group=4,
                                      topk_group=2, routed_scale=2.5), 0.5),
    "q48-interleaved-softmax": (dict(q_lora_rank=48, score_func="softmax"), 0.0),
    "q0-plain-sigmoid-groups": (dict(rope_interleave=False, score_func="sigmoid", n_group=4, topk_group=2,
                                     moe_renorm=False, routed_scale=2.5), 0.5),
}
MAX_SEQ = 32


# -- the router ---------------------------------------------------------------

def _route_inputs(seed: int, e: int = 16, d: int = 8, n: int = 24):
    """h (1, n, D): one-hot rows, so that each token's router logits are
    one column of w_router exactly; w_router (E, D) on a grid of quarters
    (ties everywhere), column 0 all equal (the first token's logits all
    tie); bias (E,) of -1.75..0 in quarters."""
    rng = np.random.default_rng(seed)
    h = np.zeros((1, n, d), np.float32)
    h[0, np.arange(n), rng.integers(0, d, n)] = 1.0
    h[0, 0, :], h[0, 0, 0] = 0.0, 1.0
    w = (np.round(rng.standard_normal((e, d)) * 2) / 4).astype(np.float32)
    w[:, 0] = 0.25
    bias = (-rng.integers(0, 8, e) / 4).astype(np.float32)
    return h, w, bias


def _masked_chosen(h, w, bias, idx, groups: int, keep: int) -> int:
    """Rows whose chosen experts include one of a group that did not
    survive (its choice 0.0 above a surviving expert's): numpy's own group
    ranking, the lower group first among equal scores."""
    choice = (1 / (1 + np.exp(-np.einsum("btd,ed->bte", h, w))) + bias)[0]
    grouped = choice.reshape(len(choice), groups, -1)
    gscore = np.sort(grouped, axis=-1)[..., -2:].sum(-1)
    survive = np.argsort(-gscore, axis=-1, kind="stable")[:, :keep]
    per = choice.shape[-1] // groups
    return sum(any(e // per not in survive[i] for e in idx[0, i]) for i in range(len(choice)))


@pytest.mark.parametrize("score_func", ["softmax", "sigmoid"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("renorm", [True, False])
def test_route_matches_jax(score_func, groups, renorm):
    """16 experts, 4 a token; with groups, 4 groups of 4 of which 2 survive.
    The first token's logits all tie (so do its group scores); with sigmoid
    scores, experts of masked groups (0.0) are chosen over surviving ones
    whose scores plus biases fall below 0 in some rows."""
    cfg = dict(n_expert=16, n_expert_used=4, n_group=groups, topk_group=2 if groups > 1 else 1,
               score_func=score_func, moe_renorm=renorm, routed_scale=2.5)
    h, w, bias = _route_inputs(7 + groups)
    jw, ji = jds.deepseek_route(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias), jds.DeepseekConfig(**cfg))
    tw, ti = deepseek.deepseek_route(T(h), T(w), T(bias), deepseek.DeepseekConfig(**cfg))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert nmse(jw, tw.numpy()) <= 1e-12
    if groups > 1 and score_func == "sigmoid":
        assert _masked_chosen(h, w, bias, ti.numpy(), groups, 2) > 0


def test_route_ties_pick_jax_s():
    """Ties at all three rankings in one row, planted: every logit equal, so
    every group scores the same, every expert scores the same, and the
    lower index wins each time."""
    h = np.zeros((1, 1, 4), np.float32)
    h[0, 0, 0] = 1.0
    w = np.zeros((16, 4), np.float32)
    bias = np.zeros(16, np.float32)
    for fn in ("sigmoid", "softmax"):
        cfg = dict(n_expert=16, n_expert_used=4, n_group=4, topk_group=2, score_func=fn)
        _, ji = jds.deepseek_route(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias), jds.DeepseekConfig(**cfg))
        _, ti = deepseek.deepseek_route(T(h), T(w), T(bias), deepseek.DeepseekConfig(**cfg))
        assert ti[0, 0].tolist() == np.asarray(ji)[0, 0].tolist() == [0, 1, 2, 3]


# -- tiny f32 files -----------------------------------------------------------

def _write(path, kind: str, seed: int = 0, **changes):
    over, bias_std = KINDS[kind]
    cfg = deepseek.DeepseekConfig(**dict(TINY, **over, **changes))
    deepseek.write_random_gguf(path, cfg, seed=seed, n_ff_exp=24, default_type=GGMLType.F32, bias_std=bias_std)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("deepseek")
    return {kind: _write(d / f"{kind}.gguf", kind, seed=i) for i, kind in enumerate(KINDS)}


def _models(path, max_seq: int = MAX_SEQ):
    jg = JGGUFFile(str(path))
    jm = jds.Deepseek(jgpt2.load_params(jg, jnp.float32), jds.config_from_gguf(jg), max_seq=max_seq)
    jg.close()
    tm = deepseek.Deepseek.from_gguf(path, dtype=torch.float32, keep_quantized=False, device="cpu", max_seq=max_seq)
    return jm, tm


def _prompt(t: int, seed: int = 0):
    return np.random.default_rng(100 + seed).integers(0, TINY["n_vocab"], (1, t)).astype(np.int32)


_jforward = jax.jit(jds.forward, static_argnums=(1,))  # equal to op by op on these files (NMSE 1e-14 of each other)


@pytest.mark.parametrize("kind", list(KINDS))
def test_file_loads_and_runs_as_jax(files, kind):
    jm, tm = _models(files[kind])
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert registry.model_class("deepseek2") is deepseek.Deepseek
    assert list(tm.params) == list(jm.params)
    carried = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, device="cpu")
    for name, p in tm.params.items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(jm.params[name]), err_msg=name)
        assert torch.equal(carried[name], p), name
    assert tm.params["blk.1.ffn_down_exps.weight"].shape == (8, 64, 24)
    for t in (20, 8):  # 20 tokens: the grouped experts; 8: the dense sum
        prompt = _prompt(t, seed=t)
        jl, jcache = _jforward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32),
                               jm.new_cache(jnp.float32), jnp.int32(0))
        zero = torch.zeros((), dtype=torch.int32)
        tl, tcache = deepseek.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1),
                                      tm.new_cache(torch.float32), zero, prefill=True)
        assert nmse(jl, tl.numpy()) <= 1e-10, (t, nmse(jl, tl.numpy()))
        ids = []
        for n_past in range(t, t + 2):
            ids.append(int(np.argmax(np.asarray(jl)[0, -1])))
            jl, jcache = _jforward(jm.params, jm.cfg, jnp.asarray([[ids[-1]]], jnp.int32),
                                   jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
            pos = torch.tensor(n_past, dtype=torch.int32)
            tl = deepseek.forward(tm.params, tm.cfg, torch.tensor([[ids[-1]]]), pos.expand(1), tcache, pos)[0]
            assert nmse(jl, tl.numpy()) <= 1e-10, (t, n_past, nmse(jl, tl.numpy()))
        ids.append(int(np.argmax(np.asarray(jl)[0, -1])))
        assert tm.generate(prompt, 3) == ids


# -- a Q4_K file through the kernels' plain versions --------------------------

@pytest.fixture(scope="module")
def q4k_file(tmp_path_factory):
    """E 256, 2 heads (nope 64, rope 64, v 128), rank 256; the dense layer's
    ffn_down at K = 768 (n_ff); one MoE layer, its shared experts of 256; a
    Q6_K head."""
    cfg = deepseek.DeepseekConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=2, n_layer=2, n_ff=768, n_dense_lead=1,
                                  kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=64, v_head_dim=128, n_expert=4,
                                  n_expert_used=2, n_shared=2, score_func="sigmoid", n_group=2, topk_group=1)
    path = tmp_path_factory.mktemp("deepseek_q4k") / "deepseek-q4k.gguf"
    deepseek.write_random_gguf(path, cfg, seed=4, n_ff_exp=128, types={"output.weight": GGMLType.Q6_K}, bias_std=0.5)
    return path


def test_q4k_file_matches_jax_with_c_at_one_row(q4k_file):
    """Three 40-token prompts, each a prefill and 2 decode steps.  The JAX
    forward jitted: over these planes its logits equal op by op's bit for
    bit (each step read the same NMSE against the port both ways)."""
    jm = jds.Deepseek.from_gguf(str(q4k_file), dtype=jnp.float32, keep_quantized=True, max_seq=MAX_SEQ + 16)
    tm = deepseek.Deepseek.from_gguf(q4k_file, dtype=torch.float32, device="cpu", max_seq=MAX_SEQ + 16)
    down = tm.params["blk.0.ffn_down.weight"]
    assert qmatmul.select_kernel(down, 1) == "q4k_matmul" and down.k == 768
    assert isinstance(tm.params["blk.0.attn_kv_b.weight"], torch.Tensor)
    qmatmul._selection_log.clear()
    steps = []
    for seed in (1, 2, 3):
        prompt = _prompt(40, seed=seed)
        jl, jcache = _jforward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32),
                               jm.new_cache(jnp.float32), jnp.int32(0))
        zero = torch.zeros((), dtype=torch.int32)
        tl, tcache = deepseek.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1),
                                      tm.new_cache(torch.float32), zero)
        # C's bf16 roundings of activations flip after last-bit differences
        # of the norms, as in tests/test_torch_llama_q4.py (read: 1.6e-6 to
        # 1.9e-6): its gate, 1e-5 a step, 1e-4 a row
        want, got = np.asarray(jl), tl.numpy()
        assert nmse(want, got) <= 1e-5 and max(nmse(want[0, i], got[0, i]) for i in range(40)) <= 1e-4
        top2 = np.sort(want[0, -1])[-2:]
        assert top2[1] - top2[0] <= 1e-3 or np.argmax(want[0, -1]) == np.argmax(got[0, -1])
        # each decode step from JAX's cache rows: the prefill's flips moved
        # the second layer's latent rows by NMSE 4e-8, which a step spreads
        # to 1.6e-5
        assert nmse(np.asarray(jcache[1][0]), tcache[1][0].numpy()) <= 1e-6
        for n_past in (40, 41):
            tok = int(np.argmax(np.asarray(jl)[0, -1]))
            tcache = [(T(c), T(k)) for c, k in jcache]
            jl, jcache = _jforward(jm.params, jm.cfg, jnp.asarray([[tok]], jnp.int32),
                                   jnp.full((1,), n_past, jnp.int32), jcache, jnp.int32(n_past))
            pos = torch.tensor(n_past, dtype=torch.int32)
            tl = deepseek.forward(tm.params, tm.cfg, torch.tensor([[tok]]), pos.expand(1), tcache, pos)[0]
            steps.append(nmse(jl, tl.numpy()))
            top2 = np.sort(np.asarray(jl)[0, -1])[-2:]
            assert top2[1] - top2[0] <= 1e-3 or np.argmax(np.asarray(jl)[0, -1]) == int(tl[0, -1].argmax())
    # bit for bit, but where a last-bit difference of a norm flips one int8
    # code of kernel A's activations (about 2e-5 a code in this tiny model:
    # test_torch_gptj_q8.assert_same_choice); read: one step of six at 2.6e-5
    assert max(steps) <= 1e-4 and sum(v > 1e-12 for v in steps) <= 2, steps
    report = qmatmul.kernel_selection_report()
    assert any("K=768" in line and "gemv-M" in line and "q4k_matmul" in line for line in report), report


# -- the q8 latent cache ------------------------------------------------------

def test_q8_latent_cache_matches_jax(files):
    """A 12-token prefill and a step into q8 caches: the codes and scales of
    every layer's latent and rope key as JAX writes them (codes off by one
    where a last-bit difference crosses a rounding edge: at most 1 in 1000),
    logits within NMSE 1e-6; then the engine's ids with a q8 cache."""
    jm, tm = _models(files["q48-plain-sigmoid-groups"])
    prompt = _prompt(12, seed=3)
    jcache = jm.new_cache("q8_kv")
    tcache = tm.new_cache("q8_kv")
    assert isinstance(tcache[0][0], QuantKV) and tcache[0][0].codes.shape == (1, 1, MAX_SEQ, 32)
    jl, jcache = _jforward(jm.params, jm.cfg, jnp.asarray(prompt), jnp.zeros((1,), jnp.int32), jcache, jnp.int32(0))
    zero = torch.zeros((), dtype=torch.int32)
    tl, _ = deepseek.forward(tm.params, tm.cfg, T(prompt).long(), zero.expand(1), tcache, zero)
    assert nmse(jl, tl.numpy()) <= 1e-6
    for jpair, tpair in zip(jcache, tcache):
        for j, t in zip(jpair, tpair):
            assert isinstance(j, JQuantKV)
            off = np.abs(np.asarray(j.codes, np.int32) - t.codes.numpy().astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3
            np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales), rtol=1e-6)
    prompts = [[1, 2, 3], [9, 7], [100, 5, 31, 2]]
    mk = lambda m, cls: cls(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype="q8_kv")
    assert _run(mk(tm, Engine), prompts, 6) == _run(mk(jm, JEngine), prompts, 6)


# -- the paged step -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["q0-interleaved-softmax", "q48-plain-sigmoid-groups"])
def test_paged_step_matches_jax(files, kind):
    """Two live slots at positions 5 and 11 and an inactive third over MLA
    pools (the latent and the rope key, one head) of random rows: logits
    NMSE <= 1e-10, the pools within 1e-5."""
    jm, tm = _models(files[kind])
    cfg = tm.cfg
    pcfg = dict(n_pages=9, page_size=4, max_pages_per_seq=4)
    mgr = paged_kv.PagedKVManager(cfg.n_layer, 1, (cfg.kv_lora_rank, cfg.qk_rope_dim), 3,
                                  paged_kv.PagedConfig(**pcfg), torch.float32, "cpu")
    assert mgr.pools[0][0].shape == (10, 1, 4, 32) and mgr.pools[0][1].shape == (10, 1, 4, 8)
    rng = np.random.default_rng(3)
    pools = [tuple(rng.standard_normal((10, 1, 4, d)).astype(np.float32) for d in (32, 8))
             for _ in range(cfg.n_layer)]
    tables = np.array([[3, 7, 0, 0], [8, 1, 6, 2], [0, 0, 0, 0]], np.int32)
    args = [np.array([[17], [200], [0]], np.int32), np.array([5, 11, 0], np.int32), tables,
            np.array([7, 6, 9], np.int32), np.array([1, 3, 0], np.int32)]
    active = np.array([True, True, False])
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


# -- the Engine ---------------------------------------------------------------

def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=4)
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind", ["dense", "paged-prefix-cache", "chunked"])
def test_engine_matches_jax(files, kind):
    """2 slots over a sigmoid, grouped file.  Paged: pages of 4 with the
    prefix cache, a warm request first; chunked: chunks of 4.  The same ids
    as JAX's engine and as each request alone."""
    jm, tm = _models(files["q48-plain-sigmoid-groups"])
    rng = np.random.default_rng(4)
    common = [int(x) for x in rng.integers(1, 255, 9)]
    prompts = [common + [3], [9, 9, 1], common + [4, 8]]

    def mk(m, eng_cls):
        kw = dict(max_batch=2, max_seq=MAX_SEQ, cache_dtype=jnp.float32 if eng_cls is JEngine else torch.float32)
        if kind == "paged-prefix-cache":
            pg = jpaged if eng_cls is JEngine else paged_kv
            kw.update(horizon=4, paged=pg.PagedConfig(n_pages=20, page_size=4, max_pages_per_seq=8,
                                                      prefix_cache=True))
        elif kind == "chunked":
            kw.update(prefill_chunk=4)
        return eng_cls(m, **kw)

    jeng, teng = mk(jm, JEngine), mk(tm, Engine)
    if kind == "paged-prefix-cache":
        assert teng.mgr.pools[0][0].shape[1:] == (1, 4, 32)
        for eng in (jeng, teng):
            _run(eng, [common + [2]], 3)
    want = _run(jeng, prompts, 6)
    assert _run(teng, prompts, 6) == want
    assert [tm.generate(np.asarray([p]), 6) for p in prompts] == want
    if kind == "paged-prefix-cache":
        assert teng.cached_prefix_tokens == jeng.cached_prefix_tokens > 0


def test_snapshots_preemption_and_forks(files):
    """Page pressure (three pages of 8 for two slots of one prompt): one
    slot's latent pages go to a host snapshot and come back, the ids those
    of the request alone (test_engine_matches_jax holds the paged engine
    against JAX's), one prefill a request,
    every page free at the end.  A dense engine at horizon 1: an urgent
    arrival preempts a running slot, which resumes from its snapshot with
    its uncontended ids.  Greedy forks of one prompt: one prefill, each fork
    the request alone."""
    tm = deepseek.Deepseek.from_gguf(files["q0-plain-sigmoid-groups"], dtype=torch.float32, keep_quantized=False,
                                     device="cpu", max_seq=30)
    teng = Engine(tm, max_batch=2, max_seq=30, cache_dtype=torch.float32, horizon=4,
                  paged=paged_kv.PagedConfig(n_pages=3, page_size=8, max_pages_per_seq=4))
    solo = lambda p, n: _run(Engine(tm, max_batch=1, max_seq=30, cache_dtype=torch.float32), [p], n)[0]
    assert _run(teng, [[1, 2, 3]] * 2, 12) == [solo([1, 2, 3], 12)] * 2
    assert teng.prefill_count == 2 and teng.mgr.free_pages() == 3
    prompts = ([1, 2, 3], [4, 5], [9, 9, 1])
    eng = Engine(tm, max_batch=2, max_seq=30, cache_dtype=torch.float32, horizon=1)
    r1, r2 = eng.submit(prompts[0], 8, priority=5), eng.submit(prompts[1], 8, priority=5)
    for _ in range(3):
        eng._admit(32)
        eng._tick()
    running = list(eng.slots)
    r3 = eng.submit(prompts[2], 8, priority=0)
    res = eng.run()
    assert [res[r] for r in (r1, r2, r3)] == [solo(p, 8) for p in prompts]
    assert sum(r.preempted for r in running) == 1 and eng.prefill_count == 3
    eng = Engine(tm, max_batch=4, max_seq=30, cache_dtype=torch.float32)
    rids = eng.submit_many([2, 7, 1, 4], 3, 6)
    res = eng.run(bucket=4)
    assert eng.prefill_count == 1 and [res[r] for r in rids] == [solo([2, 7, 1, 4], 6)] * 3


def test_draft_engine_gives_the_plain_ids_and_paged_draft_raises(files):
    """A 2-layer self-draft (the target's own tensors) at k = 3 on the dense
    engine: the ids of JAX's plain engine (greedy speculation emits the
    plain ids in f32), some drafts accepted.  A paged engine over a Deepseek
    target refuses a draft in both packages."""
    jm, tm = _models(files["q0-interleaved-softmax"])
    prompts = [[1, 2, 3], [9, 7], [100, 5, 31, 2]]
    want = _run(JEngine(jm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=jnp.float32), prompts, 8)
    draft = deepseek.Deepseek(tm.params, dataclasses.replace(tm.cfg, n_layer=2), max_seq=MAX_SEQ, device="cpu")
    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=draft, draft_k=3)
    assert eng.draft_cache[0][0].shape == (2, 1, MAX_SEQ, 32)
    assert _run(eng, prompts, 8) == want
    assert eng.spec_rounds > 0 and eng.spec_accepted > 0
    jdraft = jds.Deepseek(jm.params, dataclasses.replace(jm.cfg, n_layer=2), max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="speculative \\+ paged KV"):
        JEngine(jm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=jnp.float32, draft=jdraft,
                paged=jpaged.PagedConfig(n_pages=20, page_size=4, max_pages_per_seq=8))
    with pytest.raises(ValueError, match="speculative \\+ paged KV"):
        Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=draft,
               paged=paged_kv.PagedConfig(n_pages=20, page_size=4, max_pages_per_seq=8))


# -- finetuning ---------------------------------------------------------------

def _pattern(n):
    return np.asarray(([7, 11, 23, 42, 5, 99, 3] * (n // 7 + 1))[:n], np.int32)


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_finetune_matches_jax(files, kind):
    """3 AdamW steps of batch 2 x 16 (32 tokens: the grouped experts) on the
    sigmoid, grouped file: full weights (losses within 1e-5, every trained
    tensor within NMSE 1e-8) and LoRA on the default targets (attn_output
    and the dense layer's SwiGLU: losses within 1e-5, every adapter a within
    1e-9 and b within 1e-3)."""
    path, toks = str(files["q48-plain-sigmoid-groups"]), _pattern(300)
    kw = dict(seq_len=16, batch=2, steps=3)
    if kind == "full":
        want, jopt = jax_finetune(path, toks, adamw=JaxAdamWConfig(alpha=3e-3), **kw)
        got, opt = finetune(path, toks, adamw=AdamWConfig(alpha=3e-3), device="cpu", **kw)
        trained, jtrained = opt.params, jopt.params
        gate = {"": 1e-8}
    else:
        want, jtrained = jax_finetune_lora(path, toks, rank=4, adamw=JaxAdamWConfig(alpha=1e-3), **kw)
        got, trained = finetune_lora(path, toks, rank=4, adamw=AdamWConfig(alpha=1e-3), device="cpu", **kw)
        assert sorted(trained) == sorted(jtrained) and len(trained) == 3 + TINY["n_layer"]
        trained = {f"{n}/{ab}": t[ab] for n, t in trained.items() for ab in "ab"}
        jtrained = {f"{n}/{ab}": t[ab] for n, t in jtrained.items() for ab in "ab"}
        gate = {"/a": 1e-9, "/b": 1e-3}
    assert np.abs(np.array(want) - np.array(got)).max() <= 1e-5, (want, got)
    assert got[-1] < got[0] and set(trained) == set(jtrained)
    for name, p in trained.items():
        g = next(v for k, v in gate.items() if name.endswith(k))
        assert nmse(np.asarray(jtrained[name]), p.detach().numpy()) <= g, name


def test_qlora_follows_jax(tmp_path):
    """QLoRA (keep_quantized=True) of a Q4_K file: with attn_kv_b quantized
    (planes), JAX's forward fails where it reshapes it, and so does the
    port's; with an F32 attn_kv_b both run, losses within 1e-4 over 2 steps,
    the adapters' a within 1e-9."""
    cfg = deepseek.DeepseekConfig(**dict(TINY, v_head_dim=16, n_layer=2, score_func="softmax", moe_renorm=False))
    toks, kw = _pattern(300), dict(rank=4, keep_quantized=True, seq_len=16, batch=2, steps=2)
    planes = tmp_path / "planes.gguf"
    deepseek.write_random_gguf(planes, cfg, seed=5, n_ff_exp=32)
    with pytest.raises(AttributeError, match="reshape"):
        jax_finetune_lora(str(planes), toks, **kw)
    with pytest.raises(TypeError, match="attn_kv_b"):
        finetune_lora(planes, toks, device="cpu", **kw)
    dense_kv_b = tmp_path / "dense-kv-b.gguf"
    deepseek.write_random_gguf(dense_kv_b, cfg, seed=5, n_ff_exp=32,
                               types={f"blk.{i}.attn_kv_b.weight": GGMLType.F32 for i in range(2)})
    want, jtrained = jax_finetune_lora(str(dense_kv_b), toks, adamw=JaxAdamWConfig(alpha=1e-3), **kw)
    got, trained = finetune_lora(dense_kv_b, toks, adamw=AdamWConfig(alpha=1e-3), device="cpu", **kw)
    assert np.abs(np.array(want) - np.array(got)).max() <= 1e-4, (want, got)
    for name, ab in trained.items():
        assert nmse(np.asarray(jtrained[name]["a"]), ab["a"].numpy()) <= 1e-9, name


def test_finetune_cli_on_a_deepseek2_file(files, tmp_path, capsys):
    """The finetune CLI (full weights, then LoRA with an adapter) on a
    deepseek2 file with --device cpu: the trained file loads in both
    packages, which give it the same greedy ids."""
    from ggml_tpu_torch.cli import finetune as ft_cli

    np.save(tmp_path / "toks.npy", _pattern(200))
    out = tmp_path / "trained.gguf"
    args = [str(files["q0-interleaved-softmax"]), str(out), "--tokens", str(tmp_path / "toks.npy"), "--seq", "16",
            "--batch", "2", "--steps", "2", "--device", "cpu"]
    ft_cli.main(args)
    assert "final loss" in capsys.readouterr().out
    jm, tm = _models(out)
    prompt = _prompt(5, seed=7)
    assert tm.generate(prompt, 4) == [int(t) for t in jm.generate(prompt, 4)]
    ft_cli.main(args + ["--lora-rank", "2", "--lora-out", str(tmp_path / "adapter.gguf")])
    assert (tmp_path / "adapter.gguf").exists() and "+ adapter" in capsys.readouterr().out


# -- the CLI ------------------------------------------------------------------

def test_generate_on_a_deepseek2_file_is_the_jax_cli_text(tmp_path, monkeypatch, capsys):
    """A deepseek2 file with a 256-entry vocabulary of byte tokens: the CLI's
    greedy text, dense f32, as JAX's CLI prints it; load_model gives a
    Deepseek."""
    path = tmp_path / "deepseek-vocab.gguf"
    cfg = deepseek.DeepseekConfig(**dict(TINY, **KINDS["q48-plain-sigmoid-groups"][0]))
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens[1], tokens[2] = "<s>", "</s>"
    for i, word in enumerate(("▁hello", "▁latent", "▁attention", "▁route", "▁tokens"), start=200):
        tokens[i] = word
    deepseek.write_random_gguf(path, cfg, seed=9, n_ff_exp=24, default_type=GGMLType.F32, bias_std=0.5,
                               tokenizer=dict(model="llama", tokens=tokens, scores=[0.0] * 256, bos_token_id=1,
                                              eos_token_id=2))
    assert isinstance(registry.load_model(path, device="cpu", max_seq=16), deepseek.Deepseek)
    argv = [str(path), "-p", "hello latent attention", "-n", "6", "--top-k", "1", "--seed", "0"]
    monkeypatch.setattr(sys, "argv", ["generate"] + argv)
    jcli.main()
    want = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello latent attention"), (got, want)
