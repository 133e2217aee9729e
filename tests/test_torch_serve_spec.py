"""The port's speculative Engine (serve.Engine(draft=, draft_k=)) against the
JAX package's on the CPU, over the f32 GGUF files of
tests/test_torch_serve.py (Llama GQA 4/2, GPT-J, GPT-2) and the unrelated
Llama draft of tests/test_torch_speculative.py.

- greedy ids equal JAX's Engine(draft=) and the port's plain dense engine,
  for a dense Llama engine (stretches of SPEC_STRETCH rounds, then single
  rounds at the window's margin), a paged one with the prefix cache (the
  port's suffix prefills mirror the whole sequence into the draft; JAX's
  engine takes no prefix hit with a draft), a chunked one, a dense GPT-J
  engine and a paged GPT-2 one (the generic verify adapter), each GPT
  target with a 1-layer self-draft over its own tensors;
- the draft cache after a chunked admission within 2e-4 relative (2e-5
  absolute) of a direct draft prefill (tests/test_serve.py's gate);
- a preemption: the evicted slot's draft rows go to the host with its
  snapshot and come back bit for bit; every id equals the request alone;
- the sampled engine, dense and paged: the same ids from a seed, others
  from another, a self-draft accepting every draft;
- per-request sampling refused in speculative mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv
from ggml_tpu_torch.models import gpt2, gptj, llama
from ggml_tpu_torch.serve import SPEC_STRETCH, Engine
from tests.test_torch_serve import MAX_SEQ, _load, files  # noqa: F401  (the module fixture)
from tests.test_torch_rules import one_thread  # noqa: F401  (the autouse fixture)
from tests.test_torch_speculative import llamas  # noqa: F401  (the module fixture)


def _self_draft(jm, tm):
    """1-layer drafts over the targets' own tensors (bench.py's self-draft)."""
    mk = lambda cls, m, dev: cls(m.params, dataclasses.replace(m.cfg, n_layer=1), max_seq=MAX_SEQ, batch=1, **dev)
    if isinstance(tm, gptj.GPTJ):
        return mk(jgptj.GPTJ, jm, {}), mk(gptj.GPTJ, tm, dict(device="cpu"))
    return mk(jgpt2.GPT2, jm, {}), mk(gpt2.GPT2, tm, dict(device="cpu"))


def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=4)
    return [res[r] for r in rids]


CASES = {"llama-dense": ("llama", {}), "llama-paged-prefix": ("llama", dict(paged=True)),
         "llama-chunked": ("llama", dict(prefill_chunk=4)), "gptj-dense": ("gptj", {}),
         "gpt2-paged": ("gpt2", dict(paged=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_matches_jax(files, llamas, case):  # noqa: F811
    family, kw = CASES[case]
    if family == "llama":
        jm, tm, jd, td = llamas
    else:
        jm, tm = _load(files, family)
        jd, td = _self_draft(jm, tm)
    rng = np.random.default_rng(6)
    shared = [int(x) for x in rng.integers(1, 255, 9)]  # two full pages of 4 and one token
    prompts = [shared + [3], [1, 2, 3], shared + [4, 8], [9] * 11, [7, 7]]
    n_new = 14  # every request stops at its budget, inside the window's margin (48 - 3 - 2)

    def mk(mod, m, d, dt, eng_cls):
        extra = dict(kw)
        if extra.pop("paged", False):
            extra["paged"] = mod.PagedConfig(n_pages=40, page_size=4, max_pages_per_seq=12, prefix_cache=True)
        return eng_cls(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=dt, draft=d, draft_k=3, **extra)

    jeng = mk(jpaged, jm, jd, jnp.float32, JEngine)
    teng = mk(paged_kv, tm, td, torch.float32, Engine)
    if "paged" in kw:  # a warm request publishes the shared pages
        for e in (jeng, teng):
            _run(e, [shared + [2]], 3)
    want = _run(jeng, prompts, n_new)
    got = _run(teng, prompts, n_new)
    assert got == want, (got, want)
    plain = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32)
    assert _run(plain, prompts, n_new) == got
    assert 0 < teng.spec_rounds < sum(len(x) for x in got)
    if "paged" in kw:
        assert teng.cached_prefix_tokens == 16 and teng.mgr.free_pages() == 40  # two hits of two pages
    if "prefill_chunk" in kw:
        assert teng.chunk_dispatches > 0


def test_window_margin_and_stretch(llamas):  # noqa: F811
    """A prompt near the window: the slot stops at n_past = max_seq -
    draft_k - 2 (the margin that keeps k + 1 verify rows inside), its rounds
    single ones once a stretch's worst case would pass it; JAX's ids."""
    jm, tm, jd, td = llamas
    prompt = np.random.default_rng(9).integers(0, 256, MAX_SEQ - 12).tolist()
    engines = [cls(m, max_batch=2, max_seq=MAX_SEQ, cache_dtype=dt, draft=d, draft_k=3)
               for cls, m, d, dt in ((JEngine, jm, jd, jnp.float32), (Engine, tm, td, torch.float32))]
    want, got = (_run(e, [prompt, [5, 1]], 20) for e in engines)
    assert got == want
    assert len(got[0]) == MAX_SEQ - 3 - 2 - (MAX_SEQ - 12) + 1 and len(got[1]) == 20
    assert SPEC_STRETCH == 4


def test_chunked_admission_mirrors_draft_cache(llamas):  # noqa: F811
    """A chunked wave prefills the draft too, over the C-rounded width: a
    stale draft cache would change no id but collapse acceptance."""
    _, tm, _, td = llamas
    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=td, draft_k=2, prefill_chunk=8)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    eng.submit(prompt, 4)
    eng._admit(32)
    slot = next(i for i, s in enumerate(eng.slots) if s is not None)
    ref = td.new_cache(torch.float32)
    td.prefill(ref, np.asarray([prompt]))
    t = len(prompt)
    for (k, v), (rk, rv) in zip(eng.draft_cache, ref):
        np.testing.assert_allclose(k[slot, :, :t].numpy(), rk[0, :, :t].numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(v[slot, :, :t].numpy(), rv[0, :, :t].numpy(), rtol=2e-4, atol=2e-5)


def test_preemption_resumes_with_the_draft_snapshot(llamas):  # noqa: F811
    """An urgent arrival evicts the least urgent running slot; its snapshot
    carries the draft's rows [0, n_past), which come back bit for bit on
    resume; every request emits what it emits alone, one prefill each."""
    _, tm, _, td = llamas
    prompts = ([1, 2, 3], [4, 5], [9, 9, 1])

    def solo(p):
        e = Engine(tm, max_batch=1, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=td, draft_k=3)
        return _run(e, [p], 12)[0]

    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=td, draft_k=3)
    r1 = eng.submit(prompts[0], 12, priority=5)
    r2 = eng.submit(prompts[1], 12, priority=5)
    eng._admit(32)
    eng._tick()
    restored = []
    resume = eng._resume_from_snapshot

    def spy(i, req):
        snap = req.snapshot
        ok = resume(i, req)
        n = snap["n_past"]
        restored.append(all(torch.equal(k[i:i + 1, :, :n], sk) and torch.equal(v[i:i + 1, :, :n], sv)
                            for (k, v), (sk, sv) in zip(eng.draft_cache, snap["draft"])))
        return ok

    eng._resume_from_snapshot = spy
    r3 = eng.submit(prompts[2], 12, priority=0)
    res = eng.run()
    assert restored == [True]
    assert [res[r] for r in (r1, r2, r3)] == [solo(p) for p in prompts]
    assert eng.prefill_count == 3


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_engine_is_reproducible(llamas, paged):  # noqa: F811
    """Rejection-sampling ticks: the same ids from a seed, others from
    another, exact lengths, tokens in the vocabulary; a self-draft (p = q)
    accepts every draft."""
    _, tm, _, td = llamas
    pcfg = paged_kv.PagedConfig(n_pages=24, page_size=4, max_pages_per_seq=12) if paged else None

    def run_once(seed, draft=td):
        eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=draft, draft_k=3, seed=seed,
                     sampler={"temperature": 0.9, "top_k": 20, "top_p": 0.95}, paged=pcfg)
        return _run(eng, [[5, 1], [7, 2, 2]], 10), eng.spec_rounds

    a, _ = run_once(4)
    assert a == run_once(4)[0] != run_once(5)[0]
    assert all(len(x) == 10 and all(0 <= t < 256 for t in x) for x in a)
    _, rounds = run_once(4, draft=tm)
    assert rounds == (SPEC_STRETCH if not paged else 3)  # 10 tokens, 4 a round: one stretch, or 3 rounds


def test_engine_refuses_per_request_sampling(llamas):  # noqa: F811
    _, tm, _, td = llamas
    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, draft=td)
    with pytest.raises(ValueError, match="speculative"):
        eng.submit([1, 2], 3, sampling={"temperature": 0.5})
    with pytest.raises(ValueError, match="speculative"):
        eng.submit_many([1, 2], 2, 3, sampling={"temperature": 0.5})
    with pytest.raises(ValueError, match="draft is on"):
        Engine(tm, max_batch=2, max_seq=MAX_SEQ, draft=llama.Llama(td.params, td.cfg, device="meta"))
