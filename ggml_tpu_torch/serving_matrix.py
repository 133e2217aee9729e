"""Serving feature x model family: which Engine features drive which of the
port's families (port of ggml_tpu/serving_matrix.py, its predicates for the
fourteen families the port has: Llama, GPT-J, GPT-2, Deepseek, GLM4MoE
(glm4moe and dots1), OlmoE, DBRX, PhiMoE, GptOss, Gemma2 (gemma, gemma2,
gemma3), Phi2, Phi3, NeoX and Falcon).

Under the JAX predicates none of the fourteen is stateful (recurrent or
hybrid), so each takes chunked prefill, paged KV, the prefix cache,
speculative decoding and forks; the q8 KV cache needs a dequant-on-read in
the family forward, which JAX's q8_ok gives Llama, GPT-J, Gemma2, Phi3 and
Deepseek (its MLA latent, JAX's "mla" row) of these, and not GPT-2, Phi2,
NeoX, Falcon or the five other mixture-of-experts families
(serving_matrix.py:47-48).  The
Engine checks its flags (paged, draft, the q8 cache, prefill_chunk) against
this table, as JAX's does (serve.py:247-258).
"""

from __future__ import annotations

FEATURES = (
    "dense",            # continuous-batching dense-KV engine path
    "chunked_prefill",  # fixed-chunk prefill (Engine(prefill_chunk=C))
    "paged_kv",         # shared page-pool KV (Engine(paged=PagedConfig(...)))
    "prefix_cache",     # automatic prefix caching (a paged engine feature)
    "speculative",      # draft + verify ticks (Engine(draft=...))
    "q8_kv",            # int8-quantized dense KV cache (cache_dtype="q8_kv")
    "forks",            # shared-prefix n > 1 completions
)


def features_for(model) -> dict[str, bool]:
    """The features a constructed model wrapper supports (the predicates the
    Engine constructor enforces).  No family of the port is stateful."""
    from .models import deepseek, gemma2, gptj, llama, phi3

    q8_ok = (llama.Llama, gptj.GPTJ, gemma2.Gemma2, phi3.Phi3, deepseek.Deepseek)
    return {f: True for f in FEATURES} | {"q8_kv": isinstance(model, q8_ok)}
