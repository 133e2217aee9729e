"""The Falcon family (llama.cpp arch 'falcon') in PyTorch: GPT-J's parallel
residual with multi-query attention (one kv head: Falcon-7B) or grouped kv
heads with separate attention and MLP LayerNorms (dual_norm: the 40B
shape's new_decoder_architecture), full-head NeoX RoPE, bias-free
projections, erf GELU and a tied head.

Port of ggml_tpu/models/falcon.py.  Attention is plain f32 PyTorch over the
whole cache window (models/common.gqa_attention, whose batched products
stack a kv head's query heads: 71 of them over Falcon-7B's one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     layer_norm as _layer_norm, linear as _linear, run_layers, window_keep)
from .gptj import rope_angles
from .llama import _rope_half


@dataclass(frozen=True)
class FalconConfig:
    n_vocab: int = 65024
    n_ctx: int = 2048
    n_embd: int = 4544
    n_head: int = 71
    n_head_kv: int = 1  # multi-query (7B); the 40B shape has 8
    n_layer: int = 32
    rope_base: float = 10000.0
    eps: float = 1e-5
    dual_norm: bool = False  # 40B new_decoder_architecture: attn_norm and attn_norm_2

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> FalconConfig:
    """The falcon.* metadata with the JAX reader's keys and defaults
    (falcon.py:51-64): dual_norm where the file has blk.0.attn_norm_2."""
    md = g.metadata
    a = "falcon"
    return FalconConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 65024)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=int(md[f"{a}.attention.head_count"]),
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", 1)),
        n_layer=int(md[f"{a}.block_count"]),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        eps=float(md.get(f"{a}.attention.layer_norm_epsilon", 1e-5)),
        dual_norm="blk.0.attn_norm_2.weight" in g.tensors,
    )


def init_cache(cfg: FalconConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def forward(params: dict, cfg: FalconConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (falcon.py:75-137); the arguments as models/gemma2.forward's."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    hd = cfg.head_dim
    cos, sin = rope_angles(positions, hd, cfg.rope_base)
    rows = cache_rows(cache_len, t, max_seq)
    keep = window_keep(positions, max_seq)

    def layer(i, x):
        pre = f"blk.{i}."
        h = _layer_norm(x, params[pre + "attn_norm.weight"], params[pre + "attn_norm.bias"], cfg.eps)
        q = _linear(h, params[pre + "attn_q.weight"]).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"]).reshape(b, t, cfg.n_head_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"]).reshape(b, t, cfg.n_head_kv, hd)
        kc, vc = cache[i]
        cache_write(kc, _rope_half(k, cos, sin).transpose(1, 2), cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(_rope_half(q, cos, sin).transpose(1, 2), kc, vc, keep, 1.0 / np.sqrt(hd))
        attn_out = _linear(out.to(dt), params[pre + "attn_output.weight"])
        # parallel residual; the MLP reads ln_mlp(x) with dual_norm (40B), else the same h (7B)
        h_mlp = (_layer_norm(x, params[pre + "attn_norm_2.weight"], params[pre + "attn_norm_2.bias"], cfg.eps)
                 if cfg.dual_norm else h)
        ff = F.gelu(_linear(h_mlp, params[pre + "ffn_up.weight"]))  # erf GELU
        return x + attn_out + _linear(ff, params[pre + "ffn_down.weight"])

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
    # tied: the embedding's dense copy where the embedding is planes
    w_out = params.get("output.weight", params.get("token_embd.weight@dense", params["token_embd.weight"]))
    return _linear(x, w_out), cache


class Falcon(FamilyModel):
    """Inference wrapper: prefill and on-device greedy or sampled decode
    (common.FamilyModel over falcon.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a falcon GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`), the embedding
        also dense for the row gather and the tied head."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def falcon_7b_config() -> FalconConfig:
    """Falcon-7B at its published widths (tiiuae/falcon-7b config.json: vocab
    65024, hidden 4544, 32 layers, 71 heads of 64 over one kv head
    (multi_query), parallel_attn, bias false, rope_theta 10000,
    layer_norm_epsilon 1e-5, 2048 positions; the MLP 4 x hidden = 18176; tied
    head)."""
    return FalconConfig(n_vocab=65024, n_ctx=2048, n_embd=4544, n_head=71, n_head_kv=1, n_layer=32,
                        rope_base=10000.0, eps=1e-5)


def write_random_gguf(path, cfg: FalconConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write a falcon file as llama.cpp's converter lays one out (the fused
    query_key_value split into attn_q/k/v): the keys config_from_gguf reads,
    LayerNorms of ones with biases of std 0.02 (attn_norm_2 beside attn_norm
    where cfg.dual_norm), bias-free projections, the
    MLP 4 x n_embd wide, no output.weight: the head is the embedding
    (random_gguf.write_family_gguf: types, default_type, the fallbacks: at
    Falcon-7B's K = 4544 Q4_K takes Q5_0 and Q6_K Q8_0)."""
    from .random_gguf import write_family_gguf

    d, f = cfg.n_embd, 4 * cfg.n_embd
    nkv = cfg.n_head_kv * cfg.head_dim
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("block_count", cfg.n_layer), ("feed_forward_length", f), ("rope.freq_base", float(cfg.rope_base)),
            ("attention.layer_norm_epsilon", float(cfg.eps))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output_norm.bias", (d,), 0.02)]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_norm.bias", (d,), 0.02)]
        if cfg.dual_norm:
            tensors += [(pre + "attn_norm_2.weight", (d,), "ones"), (pre + "attn_norm_2.bias", (d,), 0.02)]
        tensors += [(pre + "attn_q.weight", (d, d), "w"), (pre + "attn_k.weight", (nkv, d), "w"),
                    (pre + "attn_v.weight", (nkv, d), "w"), (pre + "attn_output.weight", (d, d), "w"),
                    (pre + "ffn_up.weight", (f, d), "w"), (pre + "ffn_down.weight", (d, f), "w")]
    write_family_gguf(path, "falcon", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
