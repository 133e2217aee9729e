"""The port's chunked prefill and q8 KV cache in the Engine against the JAX
package's on the CPU, over the f32 GGUF files of tests/test_torch_serve.py
(Llama GQA 4/2, GPT-J, GPT-2).

- chunked prefill (prefill_chunk=8) in the batched path: admission inside
  the pipelined stretch as (max_batch, C) chunk waves (tests/test_serve.py's
  test_chunked_prefill_rides_pipelined_stretch); and in the per-request
  path, which paged admission and forks take: equal ids to JAX's chunked
  engine and to the port's bucketed engine;
- the q8 KV cache: codes equal to JAX's _quantize_rows and scales within
  1e-7 relative; the engine's ids equal JAX's q8 engine (Llama and GPT-J);
  GPT-2 refused as the serving matrix says.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu.models.common import _quantize_rows as jquantize_rows
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv
from ggml_tpu_torch.models import common
from ggml_tpu_torch.serve import Engine
from ggml_tpu_torch.serving_matrix import FEATURES, features_for
from tests.test_torch_rules import one_thread  # noqa: F401  (the autouse fixture)
from tests.test_torch_serve import _load, files  # noqa: F401  (the module fixture)


def _run(eng, prompts, n, bucket=32):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=bucket)
    return [res[r] for r in rids]


@pytest.mark.parametrize("family", ["llama", "gptj", "gpt2"])
def test_chunked_engine_matches_jax(files, family):  # noqa: F811
    """Six prompts of 2-21 tokens into 2 slots at horizon 4, so that later
    ones are admitted mid-stretch in (2, 8) chunk waves: JAX's ids, the
    bucketed engine's ids, no bucketed prefill."""
    jm, tm = _load(files, family)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, 256, n)) for n in (3, 21, 11, 2, 17, 5)]
    jeng = JEngine(jm, max_batch=2, max_seq=48, cache_dtype=jnp.float32, prefill_chunk=8, horizon=4)
    eng = Engine(tm, max_batch=2, max_seq=48, cache_dtype=torch.float32, prefill_chunk=8, horizon=4)
    want = _run(jeng, prompts, 6)
    got = _run(eng, prompts, 6)
    assert got == want, (got, want)
    assert eng.chunk_dispatches >= 6 and eng.prefill_count == len(prompts)
    assert got == _run(Engine(tm, max_batch=2, max_seq=48, cache_dtype=torch.float32, horizon=4), prompts, 6)


def test_chunked_per_request_path_matches_jax(files):  # noqa: F811
    """The per-request chunked prefill (_prefill_chunked), which a paged
    engine and a fork group take: a paged chunked engine with the prefix
    cache and a fork group of a chunked dense engine, against JAX's."""
    jm, tm = _load(files, "llama")
    prompts = [[1, 2, 3], list(range(1, 23)), [9] * 11, list(range(1, 23)) + [5, 6]]
    mk = lambda mod, m, dt, cls: cls(m, max_batch=2, max_seq=48, cache_dtype=dt, prefill_chunk=8, horizon=4,
                                     paged=mod.PagedConfig(n_pages=16, page_size=8, max_pages_per_seq=6,
                                                           prefix_cache=True))
    jeng, eng = mk(jpaged, jm, jnp.float32, JEngine), mk(paged_kv, tm, torch.float32, Engine)
    want = _run(jeng, prompts, 5)
    assert _run(eng, prompts, 5) == want
    assert eng.cached_prefix_tokens == jeng.cached_prefix_tokens == 16
    assert want == _run(Engine(tm, max_batch=2, max_seq=48, cache_dtype=torch.float32), prompts, 5)
    forks = []
    for cls, m, dt in ((JEngine, jm, jnp.float32), (Engine, tm, torch.float32)):
        e = cls(m, max_batch=2, max_seq=48, cache_dtype=dt, prefill_chunk=8, horizon=4)
        rids = e.submit_many(list(range(3, 16)), 2, 4)
        res = e.run()
        forks.append([res[r] for r in rids])
        assert e.prefill_count == 1
    assert forks[1] == forks[0] and forks[0][0] == forks[0][1]


def test_q8_rows_match_jax():
    """codes equal, scales within 1e-7 relative, and the dense view, over
    rows with a zero row and exact rounding ties (values k + 0.5 steps)."""
    rng = np.random.default_rng(9)
    kv = rng.standard_normal((2, 3, 5, 16)).astype(np.float32) * 3
    kv[0, 1, 2] = 0.0
    kv[1, 0, 0] = np.r_[127.0, np.arange(15) - 6.5]  # scale 1: every other value a rounding tie
    bf = torch.from_numpy(kv).to(torch.bfloat16)
    jcodes, jscales = jquantize_rows(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))
    codes, scales = common._quantize_rows(bf)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-7, atol=0)
    cache = common.init_layer_cache(1, 2, 3, 8, 16, common.QUANT_KV_DTYPE, "cpu")
    k = cache[0][0]
    common.cache_write(k, bf, torch.tensor([1, 3]))
    torch.testing.assert_close(k.codes[0, :, 1:6], codes[0])
    deq = k[:, :, 3:8].dequant().float().numpy()
    want = (np.asarray(jcodes, np.float32)[1] * np.asarray(jscales)[1]).astype(jnp.bfloat16).astype(np.float32)
    np.testing.assert_allclose(deq[1], want, rtol=1e-2, atol=1e-6)
    assert k.nbytes == 2 * 3 * 8 * (16 + 4)


@pytest.mark.parametrize("family", ["llama", "gptj"])
def test_q8_engine_matches_jax(files, family):  # noqa: F811
    """JAX's continuous-batching workload (prompts of 5, 9, 3 tokens for 6, 4,
    8 new in 2 slots) and a preemption with a host snapshot of both leaves,
    through the q8 engines: the same ids."""
    jm, tm = _load(files, family)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 9, 3)]
    got, want = [], []
    for cls, m, out in ((JEngine, jm, want), (Engine, tm, got)):
        eng = cls(m, max_batch=2, max_seq=48, cache_dtype="q8_kv", horizon=4)
        rids = [eng.submit(p, n) for p, n in zip(prompts, (6, 4, 8))]
        res = eng.run(bucket=4)
        out.append([res[r] for r in rids])
        eng = cls(m, max_batch=1, max_seq=48, cache_dtype="q8_kv", horizon=1)
        r1 = eng.submit(prompts[1], 8, priority=5)
        for _ in range(3):
            eng._admit(4)
            eng._tick()
        r2 = eng.submit(prompts[0], 4, priority=0)
        res = eng.run(bucket=4)
        out.append([res[r1], res[r2]])
        assert eng.prefill_count == 2
    assert got == want, (got, want)


def test_serving_matrix(files):  # noqa: F811
    models = {f: _load(files, f)[1] for f in ("llama", "gptj", "gpt2")}
    for f, m in models.items():
        feats = features_for(m)
        assert tuple(feats) == FEATURES and feats["q8_kv"] == (f != "gpt2")
        assert all(v for k, v in feats.items() if k != "q8_kv")
    with pytest.raises(TypeError, match="q8_kv"):
        Engine(models["gpt2"], max_batch=2, max_seq=48, cache_dtype="q8_kv")
    with pytest.raises(ValueError, match="cache_dtype"):
        Engine(models["llama"], max_batch=2, max_seq=48, cache_dtype="q4_kv")
