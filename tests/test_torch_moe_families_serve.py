"""Serving the other mixture-of-experts families in the port (glm4moe,
dots1, olmoe, dbrx, phimoe, gpt-oss) against the JAX package, on the CPU,
over the tiny F32 files of tests/test_torch_moe_families.py.

- The generic paged decode step and paged verify (paged_kv's adapters over
  the family forward) against JAX's for gpt-oss (sinks, a sliding window)
  and phimoe on both sides of its LongRoPE switch (a gathered window of 16
  rows = n_ctx_orig: the short factors; 32: the long ones): logits within
  NMSE 1e-10, the pools within 1e-5.
- The Engine on each architecture at 2 slots: dense, paged with the prefix
  cache, chunked and with a 1-layer self-draft give the ids of JAX's dense
  engine (phimoe's paged ones those of JAX's paged engine); a q8 KV cache
  raises TypeError in both packages.
- generate on a gpt-oss file with a vocabulary prints JAX's CLI text.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu.cli import generate as jcli
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv
from ggml_tpu_torch.cli import generate as cli
from ggml_tpu_torch.models import gptoss, registry
from ggml_tpu_torch.serve import Engine
from tests.test_torch_moe_families import ARCHS, MAX_SEQ, T, load_both, write_file
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_families_serve")
    return {arch: write_file(d / f"{arch}.gguf", arch, seed=i) for i, arch in enumerate(ARCHS)}


# -- the generic paged steps -------------------------------------------------------

@pytest.mark.parametrize("arch,pages", [("gpt-oss", 8), ("phimoe", 4), ("phimoe", 8)])
def test_paged_steps_match_jax(files, arch, pages):
    """Two live slots at positions 5 and 11 and an inactive third over pools
    of random rows (pages of 4, `pages` a slot): the decode step, then the
    verify of 3 tokens a slot, each against JAX's generic adapter."""
    jm, tm = load_both(arch, files[arch])
    cfg, jfwd, fwd = tm.cfg, ARCHS[arch][1].forward, ARCHS[arch][0].forward
    pcfg = dict(n_pages=3 * pages + 1, page_size=4, max_pages_per_seq=pages)
    rng = np.random.default_rng(pages)
    pools = [tuple(rng.standard_normal((3 * pages + 2, cfg.n_head_kv, 4, cfg.head_dim)).astype(np.float32)
                   for _ in "kv") for _ in range(cfg.n_layer)]
    tables = rng.permutation(np.arange(1, 3 * pages + 1)).reshape(3, pages).astype(np.int32)
    lengths, active = np.array([5, 11, 0], np.int32), np.array([True, True, False])
    cases = [(jpaged.make_paged_decode_step, paged_kv.make_paged_decode_step, np.array([[17], [200], [0]], np.int32),
              np.array([tables[0, 1], tables[1, 2], 0], np.int32), np.array([1, 3, 0], np.int32))]
    rows = lengths[:, None] + np.arange(3)[None, :]  # the verify's 3 rows a slot
    cases.append((jpaged.make_paged_verify_step, paged_kv.make_paged_verify_step,
                  rng.integers(0, 256, (3, 3)).astype(np.int32),
                  np.take_along_axis(tables, rows // 4, axis=1).astype(np.int32), (rows % 4).astype(np.int32)))
    for jmake, make, tokens, wpage, woff in cases:
        args = [tokens, lengths, tables, wpage, woff]
        jstep = jmake(jm, jpaged.PagedConfig(**pcfg), forward_fn=jfwd)
        want, jpools = jstep(jm.params, tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
                             *map(jnp.asarray, args), jnp.asarray(active))
        step = make(tm, paged_kv.PagedConfig(**pcfg), forward_fn=fwd)
        got, tpools = step(tm.params, [(T(k), T(v)) for k, v in pools], *(T(a).long() for a in args), T(active))
        assert nmse(np.asarray(want), got.numpy()) <= 1e-10
        for (jk, jv), (tk, tv) in zip(jpools, tpools):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


# -- the Engine --------------------------------------------------------------------

def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=4)
    return [res[r] for r in rids]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engines_match_jax(files, arch):
    """2 slots at horizon 4 over three prompts, two of which share 9 tokens:
    the dense, paged (pages of 4 with the prefix cache, after a warm
    request), chunked (chunks of 4) and drafted (a 1-layer cut of the same
    tensors, k = 3) engines all give JAX's dense engine's ids (phimoe's
    paged engine those of JAX's paged engine, whose prefill caches choose
    their rope factors by their own length); q8_kv raises TypeError."""
    jm, tm = load_both(arch, files[arch])
    common = [int(x) for x in np.random.default_rng(4).integers(1, 255, 9)]
    prompts = [common + [3], [9, 9, 1], common + [4, 8]]
    pcfg = dict(n_pages=20, page_size=4, max_pages_per_seq=8, prefix_cache=True)
    want = _run(JEngine(jm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=jnp.float32, horizon=4), prompts, 6)
    kw = dict(max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=4)
    draft = type(tm)(tm.params, dataclasses.replace(tm.cfg, n_layer=1), max_seq=MAX_SEQ, device="cpu")
    paged = Engine(tm, paged=paged_kv.PagedConfig(**pcfg), **kw)
    engines = {"dense": Engine(tm, **kw), "paged": paged, "chunked": Engine(tm, prefill_chunk=4, **kw),
               "draft": Engine(tm, draft=draft, draft_k=3, **kw)}
    want_paged = want
    if arch == "phimoe":
        jeng = JEngine(jm, max_batch=2, max_seq=MAX_SEQ, cache_dtype=jnp.float32, horizon=4,
                       paged=jpaged.PagedConfig(**pcfg))
        _run(jeng, [common + [2]], 3)
        want_paged = _run(jeng, prompts, 6)
    _run(paged, [common + [2]], 3)
    for kind, eng in engines.items():
        assert _run(eng, prompts, 6) == (want_paged if kind == "paged" else want), kind
    assert paged.cached_prefix_tokens > 0 and engines["draft"].spec_rounds > 0
    with pytest.raises(TypeError, match="q8_kv"):
        Engine(tm, max_batch=2, max_seq=MAX_SEQ, cache_dtype="q8_kv")
    with pytest.raises(TypeError):
        JEngine(jm, max_batch=2, max_seq=MAX_SEQ, cache_dtype="q8_kv")


# -- the CLI -----------------------------------------------------------------------

def test_generate_on_a_gpt_oss_file_is_the_jax_cli_text(tmp_path, monkeypatch, capsys):
    """A gpt-oss file with a 256-entry vocabulary of byte tokens: the CLI's
    greedy text, dense f32, as JAX's CLI prints it; load_model gives a
    GptOss."""
    path = tmp_path / "gpt-oss-vocab.gguf"
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens[1], tokens[2] = "<s>", "</s>"
    for i, word in enumerate(("▁hello", "▁sink", "▁window", "▁expert", "▁tokens"), start=200):
        tokens[i] = word
    write_file(path, "gpt-oss", seed=9, tokenizer=dict(model="llama", tokens=tokens, scores=[0.0] * 256,
                                                       bos_token_id=1, eos_token_id=2))
    assert isinstance(registry.load_model(path, device="cpu", max_seq=16), gptoss.GptOss)
    argv = [str(path), "-p", "hello sink window", "-n", "6", "--top-k", "1", "--seed", "0"]
    monkeypatch.setattr(sys, "argv", ["generate"] + argv)
    jcli.main()
    want = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello sink window"), (got, want)
