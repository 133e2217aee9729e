"""The port's paged KV cache (ggml_tpu_torch.paged_kv) and the paged engine
against the JAX package's on the CPU, over the f32 GGUF files of
tests/test_torch_serve.py (Llama GQA 4/2, GPT-J, GPT-2).

- PagedKVManager: the same sequence of ensure_capacity, attach_prefix,
  publish_prefix, release and reclaims gives equal tables, lengths, free
  lists, owned and attached pages and LRU order (page ids, never the hash
  values, which Python salts per process);
- paged_write and paged_gather: exact;
- each family's paged decode step against JAX's (its specialized step for
  GPT-J and the llama family, the generic adapter for GPT-2) over the same
  pools: logits NMSE <= 1e-10 (XLA's and PyTorch's sums differ in last
  bits), pools within 1e-5 relative;
- the paged engine with the prefix cache against JAX's paged engine and the
  port's own dense engine: equal ids and equal cached_prefix_tokens;
- page-pressure eviction with a snapshot and resume (tests/test_serve.py's
  paged eviction tests): equal ids, one prefill a request, every page back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv
from ggml_tpu_torch.models import gpt2
from ggml_tpu_torch.serve import Engine
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)
from tests.test_torch_serve import _load, files  # noqa: F401  (the module fixture)

FAMILIES = ["llama", "gptj", "gpt2"]


def _state(mgr, jax_side: bool) -> dict:
    return dict(tables=np.asarray(mgr.tables).tolist(), lengths=np.asarray(mgr.lengths).tolist(),
                free=list(mgr._free), owned=[list(o) for o in mgr._owned],
                attached=[list(a) for a in mgr._attached], lru=list(mgr._lru),
                published=sorted(mgr._page_hash), refs=dict(sorted(mgr._shared_ref.items())))


def test_manager_matches_jax():
    """Allocation, prefix publication and attachment, release to the LRU
    reserve, reclaims under pressure and a refused request, step by step."""
    pcfg = dict(n_pages=7, page_size=4, max_pages_per_seq=5, prefix_cache=True)
    jm = jpaged.PagedKVManager(1, 2, 8, 3, jpaged.PagedConfig(**pcfg), dtype=jnp.float32)
    tm = paged_kv.PagedKVManager(1, 2, 8, 3, paged_kv.PagedConfig(**pcfg), dtype=torch.float32, device="cpu")
    shared = list(range(1, 10))  # two full pages and one token
    script = [("ensure_capacity", 0, 10), ("publish_prefix", 0, shared), ("ensure_capacity", 1, 3),
              ("match", 2, shared + [5, 6]), ("ensure_capacity", 2, 13), ("publish_prefix", 2, shared + [5, 6, 7, 8]),
              ("release", 0), ("release", 2), ("ensure_capacity", 1, 17), ("ensure_capacity", 0, 12),
              ("match", 2, shared), ("ensure_capacity", 2, 9), ("release", 1), ("ensure_capacity", 2, 20),
              ("release", 0), ("release", 2), ("ensure_capacity", 0, 17), ("ensure_capacity", 1, 14)]
    for op, slot, *arg in script:
        for m in (jm, tm):
            if op == "match":
                pages = m.match_prefix(arg[0])
                m.attach_prefix(slot, pages[:max(0, (len(arg[0]) - 1) // 4)])
                m.lengths[slot] = 4 * len(m._attached[slot])
            elif op == "ensure_capacity":
                ok = m.ensure_capacity(slot, arg[0])
                m.lengths[slot] = arg[0] if ok else m.lengths[slot]
            else:
                getattr(m, op)(slot, *arg)
        assert _state(tm, False) == _state(jm, True), (op, slot)
        assert tm.free_pages() == jm.free_pages()
    assert tm.match_prefix(shared) == jm.match_prefix(shared)
    for active in (np.array([True, False, True]), np.array([False, True, True])):
        for t in (1, 3):
            for a, b in zip(tm.step_coords_multi(active, t), jm.step_coords_multi(active, t)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(tm.step_coords(active), jm.step_coords(active)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="logical window"):
        tm.ensure_capacity(0, 21)


def test_paged_write_and_gather_are_exact():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((6, 2, 4, 3)).astype(np.float32)
    kv = rng.standard_normal((3, 2, 3)).astype(np.float32)
    pages, offs = np.array([4, 0, 5], np.int32), np.array([3, 1, 0], np.int32)
    want = np.asarray(jpaged.paged_write(jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(pages), jnp.asarray(offs)))
    got = paged_kv.paged_write(torch.from_numpy(pool.copy()), torch.from_numpy(kv), torch.from_numpy(pages).long(),
                               torch.from_numpy(offs).long())
    np.testing.assert_array_equal(got.numpy(), want)
    tables = np.array([[2, 0, 5], [1, 1, 3]], np.int32)
    for row in tables:
        np.testing.assert_array_equal(paged_kv.paged_gather(got, torch.from_numpy(row).long()).numpy(),
                                      np.asarray(jpaged.paged_gather(jnp.asarray(want), jnp.asarray(row))))
    batched = paged_kv.paged_gather(got, torch.from_numpy(tables).long()).numpy()
    np.testing.assert_array_equal(batched, np.stack([np.asarray(jpaged.paged_gather(jnp.asarray(want), r))
                                                     for r in tables]))


@pytest.mark.parametrize("family", FAMILIES)
def test_paged_step_matches_jax(files, family):  # noqa: F811
    """Two slots with different page tables at positions 5 and 11 (the
    second across a page boundary) and an inactive third writing the trash
    page, over pools of the same random content; the JAX step run op by op."""
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
    wpage = np.array([7, 6, 9], np.int32)
    woff = np.array([1, 3, 0], np.int32)
    tokens = np.array([[17], [200], [0]], np.int32)
    jfwd, tfwd = {"gpt2": (jgpt2.forward, gpt2.forward)}.get(family, (None, None))
    with jax.disable_jit():
        jstep = jpaged.make_paged_decode_step(jm, jpaged.PagedConfig(**pcfg), forward_fn=jfwd)
        want, jpools = jstep(jm.params, tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
                             jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(tables), jnp.asarray(wpage),
                             jnp.asarray(woff), jnp.asarray(active))
    tstep = paged_kv.make_paged_decode_step(tm, paged_kv.PagedConfig(**pcfg), forward_fn=tfwd)
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in pools]
    L = lambda a: torch.from_numpy(a).long()
    got, tpools = tstep(tm.params, tpools, L(tokens), L(lengths), L(tables), L(wpage), L(woff),
                        torch.from_numpy(active))
    assert nmse(np.asarray(want), got.numpy()) <= 1e-10
    assert not got[2].any()
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=4)
    return [res[r] for r in rids]


@pytest.mark.parametrize("family", FAMILIES)
def test_paged_engine_with_prefix_cache_matches_jax(files, family):  # noqa: F811
    """A warm request publishes two pages; then two prompts that share them,
    one that does not and one repeated: the same ids and cache hits as JAX's
    paged engine (stretches of 4, then single steps), the ids of the port's
    dense engine, every page back in the pool or the LRU reserve."""
    jm, tm = _load(files, family)
    rng = np.random.default_rng(6)
    common = [int(x) for x in rng.integers(1, 255, 9)]  # two full pages and one token
    prompts = [common + [3], common + [4, 8], [9, 9, 1], common + [4, 8]]
    mk = lambda mod, m, dt, eng_cls: eng_cls(m, max_batch=2, max_seq=32, cache_dtype=dt, horizon=4,
                                             paged=mod.PagedConfig(n_pages=20, page_size=4, max_pages_per_seq=8,
                                                                   prefix_cache=True))
    jeng, teng = mk(jpaged, jm, jnp.float32, JEngine), mk(paged_kv, tm, torch.float32, Engine)
    for eng in (jeng, teng):
        _run(eng, [common + [2]], 3)
    want = _run(jeng, prompts, 6)
    got = _run(teng, prompts, 6)
    assert got == want, (got, want)
    assert teng.cached_prefix_tokens == jeng.cached_prefix_tokens >= 24
    assert teng.mgr.free_pages() == jeng.mgr.free_pages() == 20
    dense = Engine(tm, max_batch=2, max_seq=32, cache_dtype=torch.float32)
    assert _run(dense, prompts, 6) == got
    assert teng._paged_scan.stretches > 0 and teng.decode_steps > 0


@pytest.mark.parametrize("family", ["llama", "gptj"])
def test_page_pressure_eviction_resumes_from_snapshots(files, family):  # noqa: F811
    """Three pages of 8 for two slots of the same prompt (test_serve.py's
    paged eviction tests): one slot is evicted with its pages snapshotted to
    the host and resumes from them; the ids equal JAX's paged engine and the
    request alone, each request prefills once, every page comes back."""
    jm, tm = _load(files, family)
    mk = lambda mod, m, dt, eng_cls: eng_cls(m, max_batch=2, max_seq=30, cache_dtype=dt, horizon=4,
                                             paged=mod.PagedConfig(n_pages=3, page_size=8, max_pages_per_seq=4))
    jeng, teng = mk(jpaged, jm, jnp.float32, JEngine), mk(paged_kv, tm, torch.float32, Engine)
    want = _run(jeng, [[1, 2, 3]] * 2, 12)
    got = _run(teng, [[1, 2, 3]] * 2, 12)
    solo = Engine(tm, max_batch=1, max_seq=30, cache_dtype=torch.float32)
    assert got == want == [_run(solo, [[1, 2, 3]], 12)[0]] * 2
    assert teng.prefill_count == jeng.prefill_count == 2
    assert teng.mgr.free_pages() == 3


def test_paged_engine_checks(files):  # noqa: F811
    tm = _load(files, "llama")[1]
    small = paged_kv.PagedConfig(n_pages=4, page_size=4, max_pages_per_seq=2)
    with pytest.raises(ValueError, match="window"):
        Engine(tm, max_batch=2, max_seq=32, paged=small)
    with pytest.raises(ValueError, match="q8"):
        Engine(tm, max_batch=2, max_seq=8, paged=small, cache_dtype="q8_kv")
    eng = Engine(tm, max_batch=1, max_seq=8, cache_dtype=torch.float32, paged=dataclasses.replace(small, n_pages=1))
    eng.submit([1, 2, 3, 4, 5], 2)
    with pytest.raises(ValueError, match="empty page pool"):
        eng.run()
    # a per-request sampled slot sends every tick down the one-step path; at
    # temperature 0 it emits the greedy stretch's ids
    pcfg = paged_kv.PagedConfig(n_pages=8, page_size=4, max_pages_per_seq=4)
    greedy = Engine(tm, max_batch=2, max_seq=16, cache_dtype=torch.float32, horizon=4, paged=pcfg)
    stepped = Engine(tm, max_batch=2, max_seq=16, cache_dtype=torch.float32, horizon=4, paged=pcfg)
    rid = stepped.submit([3, 1, 4, 1, 5], 7, sampling={"temperature": 0.0})
    assert stepped.run()[rid] == _run(greedy, [[3, 1, 4, 1, 5]], 7)[0]
    assert stepped._paged_scan.stretches == 0 and stepped.decode_steps == 7  # the re-decode, then 6
