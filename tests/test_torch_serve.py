"""The port's continuous-batching Engine (ggml_tpu_torch.serve) on the CPU:
the per-row forward of Llama, GPT-J and GPT-2 against the JAX forward run
op by op, the Engine against JAX's Engine on the same GGUF files, and the
Engine against the port's own solo path (the engine's invariant,
docs/serving.md: every request emits what it would emit alone).  The paged,
chunked and q8 paths: tests/test_torch_paged.py and
tests/test_torch_serve_chunked.py; the engine on Q4_K planes:
tests/test_torch_serve_q4.py.

The tiny models are f32 GGUF files written by the port's writer and loaded
by both packages (no Pallas kernel runs on the JAX side: dense weights,
vector positions attend plainly).  Per-row forward: logits NMSE <= 1e-10
(XLA's and PyTorch's sums differ in last bits) and the cache rows written
within 1e-5 relative.  Engine ids: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.models import llama as jllama
from ggml_tpu.models.common import cache_write as jcache_write
from ggml_tpu.sampling import warp_logits as jwarp_logits
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch.gguf import GGUFWriter
from ggml_tpu_torch.models import common, gpt2, gptj, llama
from ggml_tpu_torch.sampling import warp_logits
from ggml_tpu_torch.serve import Engine
from tests.test_torch_llama import random_params as llama_params
from tests.test_torch_rules import nmse, one_thread, tiny_gptj_f32_gguf  # noqa: F401  (the autouse fixture)

MAX_SEQ = 48
LLAMA = llama.LlamaConfig(n_vocab=256, n_ctx=128, n_embd=64, n_head=4, n_head_kv=2, n_layer=2, n_ff=128,
                          rope_base=10000.0)
GPTJ = gptj.GPTJConfig(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_layer=2, n_rot=32)
GPT2 = dict(n_vocab=256, n_ctx=128, n_embd=32, n_head=4, n_layer=2)


def _write_llama(path):
    """A tiny Llama (GQA 4/2) of f32 weights as the port's writer stores them."""
    w = GGUFWriter()
    w.add_string("general.architecture", "llama")
    for key, val in (("context_length", LLAMA.n_ctx), ("embedding_length", LLAMA.n_embd),
                     ("attention.head_count", LLAMA.n_head), ("attention.head_count_kv", LLAMA.n_head_kv),
                     ("block_count", LLAMA.n_layer), ("feed_forward_length", LLAMA.n_ff),
                     ("vocab_size", LLAMA.n_vocab)):
        w.add_u32(f"llama.{key}", val)
    w.add_f32("llama.rope.freq_base", LLAMA.rope_base)
    w.add_f32("llama.attention.layer_norm_rms_epsilon", LLAMA.rms_eps)
    for name, p in llama_params(jllama.LlamaConfig(**dataclasses.asdict(LLAMA)), seed=23).items():
        w.add_tensor(name, p)
    w.write(path)
    return path


def _write_gpt2(path):
    w = GGUFWriter()
    w.add_string("general.architecture", "gpt2")
    for key, field in (("vocab_size", "n_vocab"), ("context_length", "n_ctx"), ("embedding_length", "n_embd"),
                       ("attention.head_count", "n_head"), ("block_count", "n_layer")):
        w.add_u32(f"gpt2.{key}", GPT2[field])
    rng = np.random.default_rng(5)
    for name, p in jgpt2.init_random_params(jgpt2.GPT2Config(**GPT2), seed=5).items():
        p = np.asarray(p)  # wider draws than the init's 0.02: fewer near-tied logits
        w.add_tensor(name, p * 5 if p.ndim == 2 else p + 0.1 * rng.standard_normal(p.shape).astype(np.float32))
    w.write(path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    return dict(llama=_write_llama(d / "llama.gguf"), gptj=tiny_gptj_f32_gguf(d / "gptj.gguf", GPTJ, seed=4),
                gpt2=_write_gpt2(d / "gpt2.gguf"))


def _load(files, family):
    path = files[family]
    if family == "llama":
        return (jllama.Llama.from_gguf(path, dtype=jnp.float32, max_seq=MAX_SEQ),
                llama.Llama.from_gguf(path, dtype=torch.float32, max_seq=MAX_SEQ, device="cpu"))
    if family == "gptj":
        return (jgptj.GPTJ.from_gguf(path, dtype=jnp.float32, max_seq=MAX_SEQ),
                gptj.GPTJ.from_gguf(path, dtype=torch.float32, max_seq=MAX_SEQ, device="cpu"))
    return (jgpt2.GPT2.from_gguf(path, max_seq=MAX_SEQ), gpt2.GPT2.from_gguf(path, max_seq=MAX_SEQ, device="cpu"))


@pytest.fixture(scope="module")
def tiny_llama(files):
    return _load(files, "llama")[1]


_FAMILIES = {"llama": (jllama.forward, llama.forward), "gptj": (jgptj.forward, gptj.forward),
             "gpt2": (jgpt2.forward, gpt2.forward)}


@pytest.mark.parametrize("family", ["llama", "gptj", "gpt2"])
def test_per_row_forward_matches_jax(files, family):
    """A 3-row batch prefilled together, then a step of two tokens at per-row
    positions (7, 3, MAX_SEQ - 1): the last row's write is clamped to rows
    MAX_SEQ - 2 and - 1, as JAX's dynamic_update_slice clamps it.  Logits
    NMSE <= 1e-10, caches within 1e-5 relative (single-token steps at
    vector positions: the engine tests below)."""
    jm, tm = _load(files, family)
    jfwd, tfwd = _FAMILIES[family]
    rng = np.random.default_rng(1)
    n_kv = getattr(tm.cfg, "n_head_kv", tm.cfg.n_head)
    jcache = [(jnp.zeros((3, n_kv, MAX_SEQ, tm.cfg.head_dim), jnp.float32),) * 2 for _ in range(tm.cfg.n_layer)]
    tcache = common.init_layer_cache(tm.cfg.n_layer, 3, n_kv, MAX_SEQ, tm.cfg.head_dim, torch.float32, "cpu")
    steps = [(rng.integers(0, 256, (3, 6)), None), (rng.integers(0, 256, (3, 2)), [7, 3, MAX_SEQ - 1])]
    with jax.disable_jit():
        for toks, pos in steps:
            if pos is None:  # the prefill at one shared position
                jpos, jlen = jnp.zeros((3,), jnp.int32), jnp.int32(0)
                tpos, tlen = torch.zeros((3,), dtype=torch.int32), torch.zeros((), dtype=torch.int32)
            else:
                jpos = jlen = jnp.asarray(pos, jnp.int32)
                tpos = tlen = torch.tensor(pos, dtype=torch.int32)
            want, jcache = jfwd(jm.params, jm.cfg, jnp.asarray(toks, jnp.int32), jpos, jcache, jlen,
                                prefill=pos is None)
            got, tcache = tfwd(tm.params, tm.cfg, torch.from_numpy(toks).long(), tpos, tcache, tlen,
                               prefill=pos is None)
            assert nmse(np.asarray(want), got.numpy()) <= 1e-10, (family, pos)
            for (jk, jv), (tk, tv) in zip(jcache, tcache):
                np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    # need_logits=False fills the same cache and skips the head
    cache = common.init_layer_cache(tm.cfg.n_layer, 3, n_kv, MAX_SEQ, tm.cfg.head_dim, torch.float32, "cpu")
    zero = torch.zeros((), dtype=torch.int32)
    none, cache = tfwd(tm.params, tm.cfg, torch.from_numpy(steps[0][0]).long(), zero.expand(3), cache, zero,
                       prefill=True, need_logits=False)
    assert none is None


def test_cache_write_clamps_and_scatters_as_jax():
    """cache_write at a 0-d or a (b,) position, with starts past S - t
    clamped: the rows JAX's dynamic_update_slice (vmapped per row) writes."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((3, 2, 10, 4)).astype(np.float32)
    kv = rng.standard_normal((3, 2, 3, 4)).astype(np.float32)
    for pos in (np.int32(2), np.int32(9), np.array([0, 8, 9], np.int32), np.array([5, 0, 7], np.int32)):
        want = np.asarray(jcache_write(jnp.asarray(base), jnp.asarray(kv), jnp.asarray(pos)))
        got = torch.from_numpy(base.copy())
        common.cache_write(got, torch.from_numpy(kv), torch.from_numpy(np.asarray(pos)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_cache_slot_helpers():
    cache = common.init_layer_cache(2, 3, 2, 8, 4, torch.float32, "cpu")
    slot = [(torch.ones((1, 2, 5, 4)), torch.full((1, 2, 5, 4), 2.0)) for _ in range(2)]
    assert common.cache_set_slot(cache, slot, 1) is cache
    k, v = common.cache_slot(cache, 1)[0]
    assert k.shape == (1, 2, 8, 4) and k.data_ptr() == cache[0][0][1:].data_ptr()  # a view
    assert float(k[:, :, :5].min()) == 1.0 and float(v[:, :, :5].max()) == 2.0 and float(k[:, :, 5:].abs().max()) == 0
    assert float(cache[1][0][0].abs().max()) == 0 and float(cache[1][0][2].abs().max()) == 0
    assert common.cache_leaf(cache) is cache[0][0]


def test_per_row_sampling_parameters_match_jax():
    """warp_logits with (B, 1) temperature and top_p tensors (the engine's
    slot vectors) against JAX's with (B, 1) arrays."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    temp = np.array([[0.5], [1.0], [1e-6], [2.0]], np.float32)
    topp = np.array([[0.9], [0.5], [1.0], [0.99]], np.float32)
    want = np.asarray(jwarp_logits(jnp.asarray(logits), jnp.asarray(temp), 10, jnp.asarray(topp)))
    got = warp_logits(torch.from_numpy(logits), torch.from_numpy(temp), 10, torch.from_numpy(topp)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)], rtol=1e-6)


@pytest.mark.parametrize("family", ["llama", "gptj", "gpt2"])
def test_engine_matches_jax_engine(files, family):
    """JAX's test_continuous_batching_matches_solo workload (3 prompts of 5,
    9, 3 tokens for 6, 4, 8 new, 2 slots, bucket 4) through both engines:
    the same ids, which equal each request run alone through the port."""
    jm, tm = _load(files, family)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 9, 3)]
    lens = [6, 4, 8]
    jeng = JEngine(jm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=jnp.float32)
    jrids = [jeng.submit(p, n) for p, n in zip(prompts, lens)]
    jres = jeng.run(bucket=4)
    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32)
    rids = [eng.submit(p, n) for p, n in zip(prompts, lens)]
    res = eng.run(bucket=4)
    for jr, r, p, n in zip(jrids, rids, prompts, lens):
        assert res[r] == jres[jr], (family, res[r], jres[jr])
        assert res[r] == tm.generate(p[None], n)


def _solo(m, prompt, n):
    e = Engine(m, max_batch=1, max_seq=MAX_SEQ, cache_dtype=torch.float32)
    rid = e.submit(prompt, n)
    return e.run()[rid]


def test_streaming_and_cancel(tiny_llama):
    """Streaming callbacks deliver tokens in order with the done flag on the
    last one; cancel() frees queued and in-flight requests."""
    m = tiny_llama
    eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32)
    streamed: dict[int, list] = {}
    on_token = lambda rid, tok, done: streamed.setdefault(rid, []).append((tok, done))
    r1 = eng.submit([1, 2, 3], 6, on_token=on_token)
    r2 = eng.submit([4, 5], 6, on_token=on_token)
    r3 = eng.submit([6], 6)
    assert eng.cancel(r3) and not eng.cancel(9999)
    res = eng.run()
    assert r3 not in res
    for rid, prompt in ((r1, [1, 2, 3]), (r2, [4, 5])):
        assert [t for t, _ in streamed[rid]] == res[rid] == _solo(m, prompt, 6)
        dones = [d for _, d in streamed[rid]]
        assert dones[-1] is True and not any(dones[:-1])
    seen = []
    eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=1)
    rid = eng.submit([1, 2, 3], 40, on_token=lambda r, t, d: seen.append(t) or (
        eng.cancel(r) if len(seen) == 3 else None))
    res = eng.run()
    assert len(res[rid]) == 3 and res[rid] == _solo(m, [1, 2, 3], 3)  # stopped right at the cancel


@pytest.mark.parametrize("snapshot", [True, False])
def test_priority_preemption(tiny_llama, snapshot):
    """An urgent arrival preempts the least urgent running slot; the evicted
    request resumes from its host KV snapshot (one prefill per request) or,
    without one, by re-prefilling prompt + output; every output equals its
    uncontended run."""
    m = tiny_llama
    prompts = ([1, 2, 3], [4, 5], [9, 9, 1])
    solo = {tuple(p): _solo(m, p, 8) for p in prompts}
    # horizon 1: three direct ticks leave both requests running (16 steps would finish them)
    eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=1)
    if not snapshot:
        eng._snapshot_slot = lambda i, req: None
    r1 = eng.submit(prompts[0], 8, priority=5)
    r2 = eng.submit(prompts[1], 8, priority=5)
    for _ in range(3):
        eng._admit(32)
        eng._tick()
    reqs = {s.rid: s for s in eng.slots}
    r3 = eng.submit(prompts[2], 8, priority=0)
    res = eng.run()
    assert res[r3] == solo[tuple(prompts[2])]
    assert res[r1] == solo[tuple(prompts[0])] and res[r2] == solo[tuple(prompts[1])]
    assert sum(r.preempted for r in reqs.values()) == 1
    assert eng.prefill_count == (3 if snapshot else 4)


def test_shared_prefix_fork(tiny_llama):
    """submit_many prefills the shared prompt once and forks n sampled
    continuations that diverge; the first token comes from the prefill's
    logits when the prompt fills its bucket."""
    eng = Engine(tiny_llama, max_batch=4, max_seq=MAX_SEQ, cache_dtype=torch.float32,
                 sampler={"temperature": 1.0, "top_k": 40, "top_p": 0.95}, seed=3)
    rids = eng.submit_many([2, 7, 1, 4], 6, 6)
    res = eng.run(bucket=4)
    assert eng.prefill_count == 1
    outs = [tuple(res[r]) for r in rids]
    assert all(len(o) == 6 and all(0 <= t < 256 for t in o) for o in outs)
    assert len(set(outs)) > 1


def test_sampling_determinism_and_greedy_slots(tiny_llama):
    """A sampled engine repeats its ids from a seed and not from another; a
    per-request temperature-0 slot beside a sampled one emits the greedy
    ids."""
    m = tiny_llama

    def run_once(seed):
        eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32,
                     sampler={"temperature": 0.8, "top_k": 20, "top_p": 0.9}, seed=seed)
        r = eng.submit([5, 1, 4], 12)
        return eng.run()[r]

    assert run_once(11) == run_once(11) != run_once(12)
    eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, seed=1)
    cold = eng.submit([5, 1, 4], 10, sampling={"temperature": 0.0})
    hot = eng.submit([3, 3], 10, sampling={"temperature": 1.5, "top_p": 0.95})
    res = eng.run()
    assert res[cold] == _solo(m, [5, 1, 4], 10)
    assert len(res[hot]) == 10 and all(0 <= t < 256 for t in res[hot])
    with pytest.raises(ValueError):
        eng.submit([1], 2, sampling={"top_k": 3})


def test_eos_mid_horizon_and_horizon_invariance(tiny_llama):
    """EOS stops a request on the device where its solo stream first emits
    it, mid-tick at horizons 4 and 16; greedy ids are the same at horizons
    1, 2 and 16."""
    m = tiny_llama
    stream = _solo(m, [3, 1, 4], 24)
    eos = stream[4]
    want = stream[: stream.index(eos) + 1]
    for horizon in (1, 4, 16):
        eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, eos_id=eos, horizon=horizon)
        r1 = eng.submit([3, 1, 4], 24)
        r2 = eng.submit([7, 7], 24)
        res = eng.run()
        assert res[r1] == want, horizon
        assert len(res[r2]) >= 1
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (4, 7, 2, 9)]
    lens = [5, 11, 3, 17]
    ref = None
    for horizon in (1, 2, 16):
        eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=horizon)
        assert eng._hb == horizon
        rids = [eng.submit(p, n) for p, n in zip(prompts, lens)]
        res = eng.run(bucket=4)
        got = [res[r] for r in rids]
        ref = ref or got
        assert got == ref, horizon
    assert Engine(m, max_batch=2, max_seq=MAX_SEQ, horizon=12)._hb == 8


def test_engine_fuzz_random_interleavings(tiny_llama):
    """Seeded submissions, priorities, cancellations and direct ticks: every
    completed request equals its uncontended run (a cancelled one, a
    prefix of it)."""
    m = tiny_llama
    solo_cache = {}

    def solo(prompt, n):
        key = (tuple(prompt), n)
        if key not in solo_cache:
            solo_cache[key] = _solo(m, list(prompt), n)
        return solo_cache[key]

    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=4)
        live, cancelled = {}, set()
        for _ in range(12):
            action = rng.random()
            if action < 0.55 or not live:
                prompt = [int(t) for t in rng.integers(0, 256, rng.integers(1, 6))]
                n = int(rng.integers(2, 8))
                live[eng.submit(prompt, n, priority=int(rng.integers(0, 3)))] = (prompt, n)
            elif action < 0.7:
                rid = int(rng.choice(list(live)))
                if eng.cancel(rid):
                    cancelled.add(rid)
            else:
                eng._admit(32)
                eng._tick()
        res = eng.run()
        for rid, (prompt, n) in live.items():
            if rid in cancelled and rid not in res:
                continue
            want = solo(prompt, n)
            if rid in cancelled:
                assert res[rid] == want[: len(res[rid])], (seed, rid)
            else:
                assert res[rid] == want, (seed, rid)


def test_window_edge_and_small_admission_group(tiny_llama):
    """A request whose sequence reaches the window stops at n_past =
    max_seq - 1 while another slot runs on (its dead lane keeps writing row
    max_seq - 1); an admission group of 2 into 4 slots fills exactly those
    slots' rows, as one (max_batch, tb) prefill."""
    m = tiny_llama
    rng = np.random.default_rng(8)
    long = rng.integers(0, 256, MAX_SEQ - 3).astype(np.int32)
    eng = Engine(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=4)
    r1 = eng.submit(long, 10)
    r2 = eng.submit([1, 2], 20)
    res = eng.run(bucket=8)
    assert res[r1] == m.generate(long[None], 3) and int(eng.n_past[0]) == MAX_SEQ - 1
    assert res[r2] == _solo(m, [1, 2], 20)

    eng = Engine(m, max_batch=4, max_seq=MAX_SEQ, cache_dtype=torch.float32)
    prompts = ([4, 5, 6], [7, 8, 9, 10, 11])
    rids = [eng.submit(p, 6) for p in prompts]
    eng._admit(8)
    assert eng.prefill_count == 2 and list(eng.n_past[:2]) == [2, 4]
    for k, v in eng.cache:
        assert float(k[2:].abs().max()) == 0 and float(v[2:].abs().max()) == 0
    for i, p in enumerate(prompts):
        solo_cache = m.new_cache(torch.float32)
        m.prefill(solo_cache, np.asarray([p]))
        for (k, v), (sk, sv) in zip(eng.cache, solo_cache):
            torch.testing.assert_close(k[i, :, :len(p)], sk[0, :, :len(p)], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(v[i, :, :len(p)], sv[0, :, :len(p)], rtol=1e-6, atol=1e-6)
    res = eng.run(bucket=8)
    assert [res[r] for r in rids] == [_solo(m, p, 6) for p in prompts]


def test_engine_refuses_what_is_not_ported(tiny_llama):
    """A custom forward and a placed cache raise, as does a paged step for
    a model of no family without a forward for the generic adapter; a draft
    builds a speculative engine (paged KV, chunked prefill and the q8 cache:
    tests/test_torch_paged.py, test_torch_serve_chunked.py; speculative
    decoding: tests/test_torch_serve_spec.py)."""
    from ggml_tpu_torch.paged_kv import PagedConfig, make_paged_decode_step

    m = tiny_llama
    spec = Engine(m, max_batch=2, max_seq=MAX_SEQ, draft=m, draft_k=2)
    assert spec.draft is m and spec.draft_k == 2 and len(spec.draft_cache) == m.cfg.n_layer
    for kw in (dict(forward_fn=llama.forward), dict(cache_put=lambda c: c)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Engine(m, max_batch=2, max_seq=MAX_SEQ, **kw)
    for family in ("Gemma2", "Phi3"):  # their own steps: tests/test_torch_dense_families_serve.py
        with pytest.raises(TypeError, match="forward_fn"):  # a stand-in of no family, and no forward for the adapter
            make_paged_decode_step(type(family, (), {})(), PagedConfig(n_pages=4, page_size=4, max_pages_per_seq=2))
    with pytest.raises(TypeError):
        Engine(object(), max_batch=2)
    eng = Engine(m, max_batch=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(MAX_SEQ, np.int32), 2)
