"""The port's perplexity harness (ggml_tpu_torch.ppl) against the JAX
package's, on the CPU.

Gates: the port's perplexity equals JAX's within 1e-5 relative on a tiny f32
GPT-2 and a tiny dense f32 GPT-J (the same GGUF files, the same token
streams, windows of 64 at the default and at an uneven stride); the JAX Δppl
test (tests/test_ppl.py) re-run in the port: a GPT-2 whose weights are Q4_K
blocks scores within 1 % through its planes (the kernels' plain versions)
of the same weights dequantized to f32; a bad stride raises ValueError.
"""

import numpy as np
import pytest
import torch

from ggml_tpu import ppl as jppl
from ggml_tpu.gguf import GGUFFile as JGGUFFile
from ggml_tpu.models import gpt2 as jgpt2
from ggml_tpu.models import gptj as jgptj
from ggml_tpu_torch import ppl
from ggml_tpu_torch.gguf import GGUFFile
from ggml_tpu_torch.models import gpt2, gptj
from tests.test_torch_rules import one_thread, tiny_gpt2_gguf  # noqa: F401  (one_thread: the autouse fixture)
from tests.test_torch_tokenizer import bpe_vocab

WINDOW = 64


def _tokens(n_vocab: int, n: int = 300, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_vocab, n).astype(np.int32)


@pytest.mark.parametrize("stride", [None, 21])
def test_gpt2_perplexity_matches_jax(tmp_path, stride):
    tokens, merges = bpe_vocab()
    path = tiny_gpt2_gguf(tmp_path / "gpt2.gguf", dict(n_vocab=len(tokens), n_ctx=128, n_embd=64, n_head=4,
                                                         n_layer=2), tokens, merges, seed=4)
    stream = _tokens(len(tokens))
    jg = JGGUFFile(path)
    want = jppl.perplexity(jgpt2.forward, jgpt2.load_params(jg), jgpt2.config_from_gguf(jg), stream, window=WINDOW,
                           stride=stride, init_cache_fn=jgpt2.init_cache)
    with GGUFFile(path) as g:
        got = ppl.perplexity(gpt2.forward, gpt2.load_params(g, device="cpu"), gpt2.config_from_gguf(g), stream,
                             window=WINDOW, stride=stride, init_cache_fn=gpt2.init_cache, device="cpu")
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) / want <= 1e-5, (got, want)


@pytest.mark.parametrize("stride", [None, 21])
def test_dense_gptj_perplexity_matches_jax(tmp_path, stride):
    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=128, n_embd=512, n_head=4, n_layer=2, n_rot=32)
    path = tmp_path / "gptj.gguf"
    gptj.write_random_gguf(path, cfg, seed=2)
    stream = _tokens(cfg.n_vocab, seed=1)
    jm = jgptj.GPTJ.from_gguf(path, dtype=np.float32, keep_quantized=False)
    want = jppl.perplexity(jgptj.forward, jm.params, jm.cfg, stream, window=WINDOW, stride=stride,
                           init_cache_fn=jgptj.init_cache)
    tm = gptj.GPTJ.from_gguf(path, dtype=torch.float32, keep_quantized=False, device="cpu")
    got = ppl.perplexity(gptj.forward, tm.params, tm.cfg, stream, window=WINDOW, stride=stride,
                         init_cache_fn=gptj.init_cache, device="cpu")
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) / want <= 1e-5, (got, want)


def test_delta_ppl_planes_vs_dequant(tmp_path):
    """tests/test_ppl.py's Δppl gate in the port, at its shapes (vocab 512,
    E 256, two layers, window 128 over 300 seeded tokens): weights from
    init_random_params (N(0, 0.02), the transformers init), every 2-D weight
    whose rows are whole 256-blocks quantized to Q4_K by the JAX writer, as
    tools/convert_hf_gpt2.py does; perplexity through the planes against the
    same weights dequantized."""
    from ggml_tpu.dtypes import GGMLType
    from ggml_tpu.gguf import GGUFWriter as JGGUFWriter

    shape = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=4, n_layer=2)
    w = JGGUFWriter()
    w.add_string("general.architecture", "gpt2")
    for key, field in (("vocab_size", "n_vocab"), ("context_length", "n_ctx"), ("embedding_length", "n_embd"),
                       ("attention.head_count", "n_head"), ("block_count", "n_layer")):
        w.add_u32(f"gpt2.{key}", shape[field])
    for name, p in jgpt2.init_random_params(jgpt2.GPT2Config(**shape), seed=9).items():
        p = np.asarray(p, np.float32)
        w.add_tensor(name, p, GGMLType.Q4_K if p.ndim == 2 and p.shape[-1] % 256 == 0 else GGMLType.F32)
    path = tmp_path / "q.gguf"
    w.write(path)
    stream = np.random.default_rng(1).integers(0, 512, 300).astype(np.int32)

    with GGUFFile(path) as g:
        cfg = gpt2.config_from_gguf(g)
        assert g.tensors["blk.0.ffn_down.weight"].ggml_type == GGMLType.Q4_K

        def score(keep_quantized):
            params = gpt2.load_params(g, keep_quantized=keep_quantized, device="cpu")
            return ppl.perplexity(gpt2.forward, params, cfg, stream, window=128, init_cache_fn=gpt2.init_cache,
                                  device="cpu")

        p_dequant, p_planes = score(False), score(True)
    assert np.isfinite(p_dequant) and p_dequant > 1.0
    assert abs(p_planes - p_dequant) / p_dequant < 0.01, (p_dequant, p_planes)


def test_bad_stride_and_short_stream_raise():
    cfg = gpt2.GPT2Config(n_vocab=16, n_ctx=16, n_embd=8, n_head=2, n_layer=1)
    params = gpt2.init_random_params(cfg, device="cpu")
    for stride in (WINDOW, WINDOW + 3, -1):
        with pytest.raises(ValueError, match="stride"):
            ppl.perplexity(gpt2.forward, params, cfg, _tokens(16), window=WINDOW, stride=stride,
                           init_cache_fn=gpt2.init_cache, device="cpu")
    with pytest.raises(ValueError, match="shorter"):
        ppl.perplexity(gpt2.forward, params, cfg, _tokens(16, n=8), window=16, init_cache_fn=gpt2.init_cache,
                       device="cpu")
