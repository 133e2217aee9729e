"""Serving the dense families in the port (gemma, gemma2, gemma3, phi2, phi3,
gptneox, falcon) against the JAX package, on the CPU, over the tiny F32
files of tests/test_torch_dense_families.py.

- The paged decode steps against JAX's and against the family's own dense
  forward over the gathered windows: the gemma family's and Phi-3's own
  steps (Phi-3 on both sides of its LongRoPE switch: a window of 16 rows =
  n_ctx_orig takes the short factors, 32 the long ones), the generic
  adapter for phi2, gptneox and falcon; logits within NMSE 1e-10 of JAX's
  and 1e-12 of the dense forward, the pools within 1e-5; the paged verify
  of 3 tokens (the generic adapter for all) against JAX's.
- The Engine on each architecture at 2 slots: dense, paged with the prefix
  cache, chunked and with a 1-layer self-draft give the ids of JAX's dense
  engine (phi3's paged ones those of JAX's paged engine, whose prefill
  caches choose their rope factors by their own length); the q8 KV cache
  gives JAX's q8 engine's ids on gemma2 and phi3, a q8 forward of the gemma
  family and phi3 is JAX's op by op within NMSE 1e-10, and a q8 cache
  raises TypeError on the others in both packages.
- serving_matrix.features_for equals JAX's on every family the port has.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu import paged_kv as jpaged
from ggml_tpu import serving_matrix as jmatrix
from ggml_tpu.models import gptj as jgptj
from ggml_tpu.models import llama as jllama
from ggml_tpu.serve import Engine as JEngine
from ggml_tpu_torch import paged_kv, serving_matrix
from ggml_tpu_torch.models import gptj, llama
from ggml_tpu_torch.serve import Engine
from tests.test_torch_dense_families import ARCHS, MAX_SEQ, T, load_both, write_file
from tests.test_torch_rules import nmse, one_thread  # noqa: F401  (the autouse fixture)

ENGINE_ARCHS = ("gemma", "gemma2", "gemma3", "phi2", "phi3", "gptneox", "falcon")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense_families_serve")
    return {case: write_file(d / f"{case}.gguf", case, seed=i) for i, case in enumerate(ARCHS)}


# -- the paged steps ---------------------------------------------------------------

@pytest.mark.parametrize("case,pages", [("gemma", 8), ("gemma2", 8), ("gemma3", 8), ("phi3", 4), ("phi3", 8),
                                        ("phi2", 8), ("gptneox", 8), ("falcon", 8)])
def test_paged_steps_match_dense_and_jax(files, case, pages):
    """Two live slots at positions 5 and 11 and an inactive third over pools
    of random rows (pages of 4, `pages` a slot): the decode step against
    JAX's and against the dense forward over the gathered windows, then the
    verify of 3 tokens a slot against JAX's."""
    jm, tm = load_both(case, files[case])
    mod, jmod = ARCHS[case][:2]
    cfg = tm.cfg
    n_kv = getattr(cfg, "n_head_kv", cfg.n_head)
    pcfg = dict(n_pages=3 * pages + 1, page_size=4, max_pages_per_seq=pages)
    rng = np.random.default_rng(pages)
    pools = [tuple(rng.standard_normal((3 * pages + 2, n_kv, 4, cfg.head_dim)).astype(np.float32) for _ in "kv")
             for _ in range(cfg.n_layer)]
    tables = rng.permutation(np.arange(1, 3 * pages + 1)).reshape(3, pages).astype(np.int32)
    lengths, active = np.array([5, 11, 0], np.int32), np.array([True, True, False])
    cases = [(jpaged.make_paged_decode_step, paged_kv.make_paged_decode_step, np.array([[17], [200], [0]], np.int32),
              np.array([tables[0, 1], tables[1, 2], 0], np.int32), np.array([1, 3, 0], np.int32))]
    rows = lengths[:, None] + np.arange(3)[None, :]  # the verify's 3 rows a slot
    cases.append((jpaged.make_paged_verify_step, paged_kv.make_paged_verify_step,
                  rng.integers(0, 256, (3, 3)).astype(np.int32),
                  np.take_along_axis(tables, rows // 4, axis=1).astype(np.int32), (rows % 4).astype(np.int32)))
    for j, (jmake, make, tokens, wpage, woff) in enumerate(cases):
        args = [tokens, lengths, tables, wpage, woff]
        jstep = jmake(jm, jpaged.PagedConfig(**pcfg), forward_fn=jmod.forward)
        want, jpools = jstep(jm.params, tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools),
                             *map(jnp.asarray, args), jnp.asarray(active))
        step = make(tm, paged_kv.PagedConfig(**pcfg), forward_fn=mod.forward)
        got, tpools = step(tm.params, [(T(k), T(v)) for k, v in pools], *(T(a).long() for a in args), T(active))
        assert nmse(np.asarray(want), got.numpy()) <= 1e-10
        for (jk, jv), (tk, tv) in zip(jpools, tpools):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        if j == 0:  # the dense forward over the gathered windows, each slot at its own position
            views = [(paged_kv.paged_gather(T(k), T(tables).long()), paged_kv.paged_gather(T(v), T(tables).long()))
                     for k, v in pools]
            dense = mod.forward(tm.params, cfg, T(tokens).long(), T(lengths).long(), views, T(lengths).long())[0]
            assert nmse(dense[:2, -1].numpy(), got[:2].numpy()) <= 1e-12


# -- the Engine --------------------------------------------------------------------

def _run(eng, prompts, n):
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run(bucket=4)
    return [res[r] for r in rids]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engines_match_jax(files, arch):
    """2 slots at horizon 4 over three prompts, two of which share 9 tokens:
    the dense, paged (pages of 4 with the prefix cache, after a warm
    request), chunked (chunks of 4) and drafted (a 1-layer cut of the same
    tensors, k = 3) engines all give JAX's dense engine's ids (phi3's paged
    engine those of JAX's paged engine); the q8 engines of gemma2 and phi3
    JAX's q8 engine's ids, the q8 forward of the gemma family and phi3 JAX's
    op by op (q8_forward_matches_jax), the others' q8 caches refused by
    both."""
    jm, tm = load_both(arch, files[arch])
    common = [int(x) for x in np.random.default_rng(4).integers(1, 255, 9)]
    prompts = [common + [3], [9, 9, 1], common + [4, 8]]
    pcfg = dict(n_pages=20, page_size=4, max_pages_per_seq=8, prefix_cache=True)
    jkw = dict(max_batch=2, max_seq=MAX_SEQ, horizon=4)
    want = _run(JEngine(jm, cache_dtype=jnp.float32, **jkw), prompts, 6)
    kw = dict(max_batch=2, max_seq=MAX_SEQ, cache_dtype=torch.float32, horizon=4)
    draft = type(tm)(tm.params, dataclasses.replace(tm.cfg, n_layer=1), max_seq=MAX_SEQ, device="cpu")
    paged = Engine(tm, paged=paged_kv.PagedConfig(**pcfg), **kw)
    engines = {"dense": Engine(tm, **kw), "paged": paged, "chunked": Engine(tm, prefill_chunk=4, **kw),
               "draft": Engine(tm, draft=draft, draft_k=3, **kw)}
    want_paged = want
    if arch == "phi3":
        jeng = JEngine(jm, cache_dtype=jnp.float32, paged=jpaged.PagedConfig(**pcfg), **jkw)
        _run(jeng, [common + [2]], 3)
        want_paged = _run(jeng, prompts, 6)
    _run(paged, [common + [2]], 3)
    for kind, eng in engines.items():
        assert _run(eng, prompts, 6) == (want_paged if kind == "paged" else want), kind
    assert paged.cached_prefix_tokens > 0 and engines["draft"].spec_rounds > 0
    kw["cache_dtype"] = "q8_kv"
    if arch in ("gemma2", "phi3"):
        assert _run(Engine(tm, **kw), prompts, 6) == _run(JEngine(jm, cache_dtype="q8_kv", **jkw), prompts, 6)
    if arch in ("gemma", "gemma2", "gemma3", "phi3"):
        q8_forward_matches_jax(arch, jm, tm, prompts[1] + [230, 230, 230])
    else:
        with pytest.raises(TypeError, match="q8_kv"):
            Engine(tm, **kw)
        with pytest.raises(TypeError):
            JEngine(jm, cache_dtype="q8_kv", **jkw)


def q8_forward_matches_jax(arch, jm, tm, prompt):
    """A prefill and 2 greedy steps over a q8 cache within NMSE 1e-10 of
    JAX's forward run op by op.  Its jitted engine is not the reference
    here: XLA fuses the bf16 dequantization into the score product and
    skips a rounding, which moved gemma3's logits by 1.7e-3 from JAX's own
    op-by-op forward (the port reads 1.8e-7 from the latter), enough to flip
    a near-tied pick of the q8 engine."""
    import jax

    from ggml_tpu.models.common import init_layer_cache as jinit

    mod, jmod = ARCHS[arch][:2]
    cfg = tm.cfg
    jc = jinit(cfg.n_layer, 1, cfg.n_head_kv, MAX_SEQ, cfg.head_dim, "q8_kv")
    tc = mod.init_cache(cfg, 1, MAX_SEQ, "q8_kv", "cpu")
    toks, pos = [prompt], 0
    for _ in range(3):
        with jax.disable_jit():
            jl, jc = jmod.forward(jm.params, jm.cfg, jnp.asarray(toks), jnp.full((1,), pos, jnp.int32), jc,
                                  jnp.int32(pos))
        p = torch.tensor(pos, dtype=torch.int32)
        tl = mod.forward(tm.params, cfg, torch.tensor(toks), p.expand(1), tc, p)[0]
        assert nmse(np.asarray(jl), tl.numpy()) <= 1e-10
        pos += len(toks[0])
        toks = [[int(np.argmax(np.asarray(jl)[0, -1]))]]


def test_serving_matrix_matches_jax(files):
    """features_for of each family's wrapper equals JAX's over the same
    file: Llama, GPT-J, Gemma2 (gemma, gemma2, gemma3) and Phi3 take the
    q8 cache; Phi2, NeoX and
    Falcon do not; every other feature holds for all."""
    pairs = [load_both(case, files[case]) for case in ENGINE_ARCHS]
    pairs.append((jllama.Llama({}, jllama.LlamaConfig(n_layer=1)), llama.Llama({}, llama.LlamaConfig(n_layer=1))))
    pairs.append((jgptj.GPTJ({}, jgptj.GPTJConfig(n_layer=1)), gptj.GPTJ({}, gptj.GPTJConfig(n_layer=1))))
    q8 = []
    for jm, tm in pairs:
        got = serving_matrix.features_for(tm)
        assert got == jmatrix.features_for(jm), type(tm).__name__
        q8.append(got["q8_kv"])
    assert q8 == [True, True, True, False, True, False, False, True, True]


# -- the CLIs ----------------------------------------------------------------------

def test_generate_lora_on_a_gemma2_file_is_the_jax_cli_text(tmp_path, monkeypatch, capsys):
    """A gemma2 file with a 256-entry SPM vocabulary (byte tokens and a few
    words) and an adapter with nonzero b on every q, k, v and ffn_down
    weight: the generate CLI's greedy text with --lora, dense bf16, as JAX's
    CLI prints it (the gemma forwards permute no rows at load, so the
    adapter merges as it is); the adapter moves the text."""
    import sys

    from ggml_tpu.cli import generate as jcli
    from ggml_tpu_torch.cli import generate as cli
    from ggml_tpu_torch.opt import lora

    path = tmp_path / "gemma2-vocab.gguf"
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens[1], tokens[2] = "<bos>", "<eos>"
    for i, word in enumerate(("▁hello", "▁soft", "▁cap", "▁window", "▁tokens"), start=200):
        tokens[i] = word
    write_file(path, "gemma2", seed=9, tokenizer=dict(model="llama", tokens=tokens, scores=[0.0] * 256,
                                                      bos_token_id=1, eos_token_id=2))
    cfg = ARCHS["gemma2"][3]
    rng = np.random.default_rng(4)
    ab = {}
    for name, (n, k) in (("attn_q.weight", (64, 64)), ("attn_k.weight", (32, 64)), ("attn_v.weight", (32, 64)),
                         ("ffn_down.weight", (64, cfg.n_ff))):
        ab[f"blk.0.{name}"] = {"a": torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32) * 0.5),
                               "b": torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32) * 0.5)}
    adapter = tmp_path / "a.gguf"
    lora.save_lora_gguf(adapter, ab, alpha=4.0, base_arch="gemma2")
    argv = [str(path), "-p", "hello soft cap", "-n", "6", "--top-k", "1", "--seed", "0", "--lora", str(adapter)]
    monkeypatch.setattr(sys, "argv", ["generate"] + argv)
    jcli.main()
    want = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.startswith("hello soft cap"), (got, want)
    cli.main(argv[:-2] + ["--device", "cpu"])
    assert capsys.readouterr().out != got


def test_finetune_cli_on_a_falcon_file(files, tmp_path, capsys):
    """cli/finetune on the tiny falcon file: full weights (the output loads
    as a Falcon), --lora-rank and --lora-quantized over the F32 base."""
    from ggml_tpu_torch.cli import finetune as ft_cli
    from ggml_tpu_torch.models import falcon, registry
    from ggml_tpu_torch.opt import lora

    np.save(tmp_path / "t.npy", np.resize(np.arange(3, 40, dtype=np.int32), 300))
    args = [str(files["falcon"]), str(tmp_path / "out.gguf"), "--tokens", str(tmp_path / "t.npy"), "--seq", "16",
            "--batch", "2", "--steps", "2", "--device", "cpu"]
    ft_cli.main(args)
    assert "final loss" in capsys.readouterr().out
    assert isinstance(registry.load_model(tmp_path / "out.gguf", device="cpu", max_seq=16), falcon.Falcon)
    for extra in (["--lora-rank", "4"], ["--lora-rank", "4", "--lora-quantized"]):
        ft_cli.main(args + extra + ["--lora-out", str(tmp_path / "a.gguf")])
        assert "+ adapter" in capsys.readouterr().out
        assert len(lora.load_lora_gguf(tmp_path / "a.gguf")[0]) == 6 * 2
