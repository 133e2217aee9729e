"""The OLMoE family (llama.cpp arch 'olmoe', AI2's OLMoE-1B-7B) in PyTorch: a
llama-shaped pre-norm decoder whose q/k RMSNorm runs over the whole
projection width before the head split (olmo2's), full rotate-half RoPE,
and a top-k mixture of experts whose softmax probabilities are taken as
they are, not renormalized (HF norm_topk_prob false).

Port of ggml_tpu/models/olmoe.py.  The experts are the llama family's
moe_ffn_block (models/llama.py: below 16 tokens the gate-masked sum over
every expert, from 16 the grouped sum over the chosen ones), attention
plain f32 PyTorch over the whole cache window (models/common.gqa_attention).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     linear as _linear, window_keep)
from .gptj import rope_angles
from .llama import _rms_norm, _rope_half, moe_ffn_block


@dataclass(frozen=True)
class OlmoEConfig:
    n_vocab: int = 50304
    n_ctx: int = 4096
    n_embd: int = 2048
    n_head: int = 16
    n_head_kv: int = 16
    n_layer: int = 16
    n_ff: int = 2048
    n_expert: int = 64
    n_expert_used: int = 8
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    # moe_ffn_block's fields: the top-k softmax probabilities as they are
    moe_renorm: bool = False
    moe_shared: bool = False

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> OlmoEConfig:
    """The olmoe.* metadata with the JAX reader's keys and defaults
    (olmoe.py:50-66)."""
    md = g.metadata
    a = "olmoe"
    n_head = int(md[f"{a}.attention.head_count"])
    return OlmoEConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 50304)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_expert=int(md[f"{a}.expert_count"]),
        n_expert_used=int(md[f"{a}.expert_used_count"]),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
    )


def init_cache(cfg: OlmoEConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def forward(params: dict, cfg: OlmoEConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (olmoe.py:76-127); the arguments as models/glm4moe.forward's."""
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
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
        # the q/k RMSNorm over the whole width, before the head split
        q = _rms_norm(_linear(h, params[pre + "attn_q.weight"]), params[pre + "attn_q_norm.weight"], cfg.rms_eps)
        k = _rms_norm(_linear(h, params[pre + "attn_k.weight"]), params[pre + "attn_k_norm.weight"], cfg.rms_eps)
        v = _linear(h, params[pre + "attn_v.weight"]).reshape(b, t, cfg.n_head_kv, hd)
        q = _rope_half(q.reshape(b, t, cfg.n_head, hd), cos, sin).transpose(1, 2)
        k = _rope_half(k.reshape(b, t, cfg.n_head_kv, hd), cos, sin).transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(q, kc, vc, keep, hd ** -0.5)
        x = x + _linear(out.to(dt), params[pre + "attn_output.weight"])
        x = x + moe_ffn_block(params, pre, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps), cfg)
    if not need_logits:
        return None, cache
    x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
    return _linear(x, params.get("output.weight", params["token_embd.weight"])), cache


class OlmoE(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode
    (common.FamilyModel over olmoe.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load an olmoe GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`), the stacked
        experts dequantized to `dtype`."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def olmoe_1b_7b_config() -> OlmoEConfig:
    """OLMoE-1B-7B-0924 at its published widths (allenai/OLMoE-1B-7B-0924
    config.json: vocab 50304, hidden 2048, 16 layers, 16 heads (16 kv
    heads), 64 experts of intermediate_size 1024, 8 a token,
    norm_topk_prob false, rope_theta 10000, rms_norm_eps 1e-5, 4096
    positions, untied output)."""
    return OlmoEConfig(n_vocab=50304, n_ctx=4096, n_embd=2048, n_head=16, n_head_kv=16, n_layer=16, n_ff=1024,
                       n_expert=64, n_expert_used=8, rope_base=10000.0, rms_eps=1e-5)


def write_random_gguf(path, cfg: OlmoEConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write an olmoe file as llama.cpp's converter lays one out: the keys
    config_from_gguf reads, the whole-width q/k norms (ones), an F32 router
    ffn_gate_inp (E, D) and the stacked experts ffn_{gate,up}_exps (E, n_ff,
    D) and ffn_down_exps (E, D, n_ff) in every layer (random_gguf.
    write_family_gguf: types, default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, e, f, nkv = cfg.n_embd, cfg.n_expert, cfg.n_ff, cfg.n_head_kv * cfg.head_dim
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("block_count", cfg.n_layer), ("feed_forward_length", f), ("expert_count", e),
            ("expert_used_count", cfg.n_expert_used), ("rope.freq_base", float(cfg.rope_base)),
            ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_q.weight", (d, d), "w"),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_v.weight", (nkv, d), "w"),
                    (pre + "attn_q_norm.weight", (d,), "ones"), (pre + "attn_k_norm.weight", (nkv,), "ones"),
                    (pre + "attn_output.weight", (d, d), "w"), (pre + "ffn_norm.weight", (d,), "ones"),
                    (pre + "ffn_gate_inp.weight", (e, d), 0.02), (pre + "ffn_gate_exps.weight", (e, f, d), "w"),
                    (pre + "ffn_up_exps.weight", (e, f, d), "w"), (pre + "ffn_down_exps.weight", (e, d, f), "w")]
    write_family_gguf(path, "olmoe", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
