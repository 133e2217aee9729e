"""The Phi-3.5-MoE family (llama.cpp arch 'phimoe') in PyTorch: a 16-expert
top-2 mixture of experts routed by sparsemixer (a threshold-masked softmax
per chosen expert, not Mixtral's top-k softmax), LongRoPE with explicit long
and short mscales, biased LayerNorms, biased q/k/v/o and a biased, untied
head.

Port of ggml_tpu/models/phimoe.py.  The long or short factors are chosen
statically by the length of the cache the forward is handed (max_seq >
n_ctx_orig: long), as JAX chooses them per compiled program, so a paged
step, which hands the forward a gathered window of P x page_size rows,
chooses by that width.  The experts run through the llama family's
moe_expert_sum (the gate-masked sum over every expert) at every length, as
JAX runs them; attention plain f32 PyTorch over the whole cache window
(models/common.gqa_attention).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     layer_norm as _layer_norm, linear as _linear, window_keep)
from .llama import _rope_half, moe_expert_sum


@dataclass(frozen=True)
class PhiMoEConfig:
    n_vocab: int = 32064
    n_ctx: int = 131072
    n_ctx_orig: int = 4096
    n_embd: int = 4096
    n_head: int = 32
    n_head_kv: int = 8
    head_dim: int = 128
    n_layer: int = 32
    n_ff: int = 6400
    n_expert: int = 16
    n_expert_used: int = 2
    router_jitter: float = 0.01
    rope_base: float = 10000.0
    longrope: bool = False
    long_mscale: float = 1.0
    short_mscale: float = 1.0
    eps: float = 1e-5


def config_from_gguf(g: GGUFFile) -> PhiMoEConfig:
    """The phimoe.* metadata with the JAX reader's keys and defaults
    (phimoe.py:54-79); LongRoPE where the file has rope_factors_long."""
    md = g.metadata
    a = "phimoe"
    n_head = int(md[f"{a}.attention.head_count"])
    n_embd = int(md[f"{a}.embedding_length"])
    n_ctx = int(md[f"{a}.context_length"])
    return PhiMoEConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 32064)),
        n_ctx=n_ctx,
        n_ctx_orig=int(md.get(f"{a}.rope.scaling.original_context_length", n_ctx)),
        n_embd=n_embd,
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        head_dim=int(md.get(f"{a}.attention.key_length", n_embd // n_head)),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_expert=int(md[f"{a}.expert_count"]),
        n_expert_used=int(md[f"{a}.expert_used_count"]),
        router_jitter=float(md.get(f"{a}.router_jitter", 0.01)),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        longrope="rope_factors_long.weight" in g.tensors,
        long_mscale=float(md.get(f"{a}.rope.scaling.long_mscale", 1.0)),
        short_mscale=float(md.get(f"{a}.rope.scaling.short_mscale", 1.0)),
        eps=float(md.get(f"{a}.attention.layer_norm_epsilon", 1e-5)),
    )


def init_cache(cfg: PhiMoEConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


@functools.cache
def _base_pow(head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """base ** (j / half) in float64 numpy cast to float32 (phimoe.py:92-93),
    copied to the device once (a captured decode graph reads it)."""
    half = head_dim // 2
    return torch.from_numpy((base ** (np.arange(half, dtype=np.float64) / half)).astype(np.float32)).to(device)


def rope_angles_phimoe(positions, cfg: PhiMoEConfig, factors, mscale: float):
    """cos, sin (b, t, 1, head_dim/2) f32 of _rope_phimoe (phimoe.py:88-101):
    the frequencies 1 / (factors * base_pow) (factors None: 1 / base_pow),
    cos and sin times mscale."""
    base_pow = _base_pow(cfg.head_dim, cfg.rope_base, positions.device)
    inv_freq = 1.0 / (factors.float() * base_pow) if factors is not None else 1.0 / base_pow
    theta = positions.float()[..., None] * inv_freq
    return (torch.cos(theta) * mscale)[:, :, None, :], (torch.sin(theta) * mscale)[:, :, None, :]


def sparsemixer_top2_gates(scores: torch.Tensor, jitter_eps: float) -> torch.Tensor:
    """The inference sparsemixer (phimoe.py:104-126): dense gate weights (...,
    E) f32 with two nonzeros a row.  Round one takes the argmax (the first
    among equal maxima, as jnp.argmax) with its weight the softmax of the
    scores masked where (max - s) / max(|s|, max) > 2 jitter_eps; round two
    the same over the scores with the first expert removed, its mask taken
    against the original scores."""
    s = scores.float()
    e = s.shape[-1]
    neg_inf = torch.full((), float("-inf"), device=s.device)

    def pick(sc, base):
        m = sc.amax(dim=-1, keepdim=True)
        idx = sc.argmax(dim=-1)
        mask = ((m - base) / torch.maximum(base.abs(), m)) > (2 * jitter_eps)
        gates = torch.softmax(torch.where(mask, neg_inf, sc), dim=-1)
        return idx, gates.gather(-1, idx[..., None])[..., 0]

    idx1, w1 = pick(s, s)
    one1 = F.one_hot(idx1, e).to(torch.float32)
    idx2, w2 = pick(torch.where(one1 > 0.5, neg_inf, s), s)
    return one1 * w1[..., None] + F.one_hot(idx2, e).to(torch.float32) * w2[..., None]


def forward(params: dict, cfg: PhiMoEConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (phimoe.py:129-192); the arguments as models/glm4moe.forward's.
    With LongRoPE the factors and mscale are the long ones when the cache
    handed in holds more than n_ctx_orig rows."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    hd = cfg.head_dim
    factors, mscale = None, 1.0
    if cfg.longrope:
        long = max_seq > cfg.n_ctx_orig
        factors = params["rope_factors_long.weight" if long else "rope_factors_short.weight"]
        mscale = cfg.long_mscale if long else cfg.short_mscale
    cos, sin = rope_angles_phimoe(positions, cfg, factors, mscale)
    rows = cache_rows(cache_len, t, max_seq)
    keep = window_keep(positions, max_seq)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        h = _layer_norm(x, params[pre + "attn_norm.weight"], params[pre + "attn_norm.bias"], cfg.eps)
        q = _linear(h, params[pre + "attn_q.weight"], params.get(pre + "attn_q.bias")).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"], params.get(pre + "attn_k.bias")).reshape(b, t, cfg.n_head_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"], params.get(pre + "attn_v.bias")).reshape(b, t, cfg.n_head_kv, hd)
        q, k = _rope_half(q, cos, sin).transpose(1, 2), _rope_half(k, cos, sin).transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(q, kc, vc, keep, hd ** -0.5)
        x = x + _linear(out.to(dt), params[pre + "attn_output.weight"], params.get(pre + "attn_output.bias"))
        h = _layer_norm(x, params[pre + "ffn_norm.weight"], params[pre + "ffn_norm.bias"], cfg.eps)
        with torch.profiler.record_function("phimoe.router"):
            gates = sparsemixer_top2_gates(_linear(h, params[pre + "ffn_gate_inp.weight"]), cfg.router_jitter)
        with torch.profiler.record_function("phimoe.moe_experts"):
            x = x + moe_expert_sum(h, params[pre + "ffn_gate_exps.weight"], params[pre + "ffn_up_exps.weight"],
                                   params[pre + "ffn_down_exps.weight"], gates.to(h.dtype))
    if not need_logits:
        return None, cache
    x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
    return _linear(x, params["output.weight"], params.get("output.bias")), cache


class PhiMoE(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode
    (common.FamilyModel over phimoe.forward); the rope factors follow the
    wrapper's max_seq."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a phimoe GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`), the stacked
        experts dequantized to `dtype`."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def phi35_moe_config() -> PhiMoEConfig:
    """Phi-3.5-MoE at its published widths (microsoft/Phi-3.5-MoE-instruct
    config.json: vocab 32064, hidden 4096, 32 layers, 32 heads over 8 kv
    heads, 16 experts of intermediate_size 6400, 2 a token,
    router_jitter_noise 0.01, rope_theta 10000, LongRoPE over
    original_max_position_embeddings 4096 to 131072 with long_mscale and
    short_mscale 1.243163121016122, rms_norm_eps 1e-5 for its LayerNorms,
    attention_bias and lm_head_bias true)."""
    return PhiMoEConfig(n_vocab=32064, n_ctx=131072, n_ctx_orig=4096, n_embd=4096, n_head=32, n_head_kv=8,
                        head_dim=128, n_layer=32, n_ff=6400, n_expert=16, n_expert_used=2, router_jitter=0.01,
                        rope_base=10000.0, longrope=True, long_mscale=1.243163121016122,
                        short_mscale=1.243163121016122, eps=1e-5)


def write_random_gguf(path, cfg: PhiMoEConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write a phimoe file as llama.cpp's converter lays one out: the keys
    config_from_gguf reads, LayerNorms of ones with biases of std 0.02,
    biased q/k/v/o and head, an F32 router ffn_gate_inp (E, D), the stacked
    experts (E, n_ff, D) and (E, D, n_ff), and, where cfg.longrope,
    rope_factors_long and rope_factors_short (head_dim / 2 values each,
    drawn from the seed: short ones in [1, 1.5), long ones rising from 1 to
    about 40, the shapes of the published arrays) (random_gguf.
    write_family_gguf: types, default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, e, f, hd = cfg.n_embd, cfg.n_expert, cfg.n_ff, cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("attention.key_length", hd), ("attention.value_length", hd), ("block_count", cfg.n_layer),
            ("feed_forward_length", f), ("expert_count", e), ("expert_used_count", cfg.n_expert_used),
            ("router_jitter", float(cfg.router_jitter)), ("rope.freq_base", float(cfg.rope_base)),
            ("rope.dimension_count", hd), ("rope.scaling.original_context_length", cfg.n_ctx_orig),
            ("rope.scaling.long_mscale", float(cfg.long_mscale)),
            ("rope.scaling.short_mscale", float(cfg.short_mscale)), ("attention.layer_norm_epsilon", float(cfg.eps))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output_norm.bias", (d,), 0.02), ("output.weight", (cfg.n_vocab, d), "w"),
               ("output.bias", (cfg.n_vocab,), 0.02)]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_norm.bias", (d,), 0.02),
                    (pre + "attn_q.weight", (nq, d), "w"), (pre + "attn_q.bias", (nq,), 0.02),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_k.bias", (nkv,), 0.02),
                    (pre + "attn_v.weight", (nkv, d), "w"), (pre + "attn_v.bias", (nkv,), 0.02),
                    (pre + "attn_output.weight", (d, nq), "w"), (pre + "attn_output.bias", (d,), 0.02),
                    (pre + "ffn_norm.weight", (d,), "ones"), (pre + "ffn_norm.bias", (d,), 0.02),
                    (pre + "ffn_gate_inp.weight", (e, d), 0.02), (pre + "ffn_gate_exps.weight", (e, f, d), "w"),
                    (pre + "ffn_up_exps.weight", (e, f, d), "w"), (pre + "ffn_down_exps.weight", (e, d, f), "w")]
    extra = {}
    if cfg.longrope:
        rng = np.random.default_rng(seed + 1)
        extra = {"rope_factors_short.weight": np.sort(1.0 + 0.5 * rng.random(hd // 2)).astype(np.float32),
                 "rope_factors_long.weight": np.sort(1.0 + 39.0 * rng.random(hd // 2) ** 2).astype(np.float32)}
    write_family_gguf(path, "phimoe", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type, arrays=extra)
