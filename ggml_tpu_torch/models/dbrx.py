"""The DBRX family (llama.cpp arch 'dbrx', Databricks DBRX) in PyTorch: a
16-expert top-4 mixture of experts under LayerNorms without bias, q, k and
v clamped to [-clip_qkv, clip_qkv] before the head split, full rotate-half
RoPE, grouped-query attention and an untied head.

Port of ggml_tpu/models/dbrx.py.  The routing (a softmax over every expert,
top-k, renormalized) and the experts are the llama family's moe_ffn_block
(models/llama.py); attention plain f32 PyTorch over the whole cache window
(models/common.gqa_attention).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     linear as _linear, window_keep)
from .gptj import rope_angles
from .llama import _rope_half, moe_ffn_block


@dataclass(frozen=True)
class DBRXConfig:
    n_vocab: int = 100352
    n_ctx: int = 32768
    n_embd: int = 6144
    n_head: int = 48
    n_head_kv: int = 8
    n_layer: int = 40
    n_ff: int = 10752
    n_expert: int = 16
    n_expert_used: int = 4
    rope_base: float = 500000.0
    clamp_kqv: float = 8.0
    eps: float = 1e-5
    # moe_ffn_block's fields
    moe_renorm: bool = True
    moe_shared: bool = False

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> DBRXConfig:
    """The dbrx.* metadata with the JAX reader's keys and defaults
    (dbrx.py:51-68); a file without attention.clamp_kqv clamps nothing."""
    md = g.metadata
    a = "dbrx"
    n_head = int(md[f"{a}.attention.head_count"])
    return DBRXConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 100352)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_expert=int(md[f"{a}.expert_count"]),
        n_expert_used=int(md[f"{a}.expert_used_count"]),
        rope_base=float(md.get(f"{a}.rope.freq_base", 500000.0)),
        clamp_kqv=float(md.get(f"{a}.attention.clamp_kqv", 0.0)),
        eps=float(md.get(f"{a}.attention.layer_norm_epsilon", 1e-5)),
    )


def init_cache(cfg: DBRXConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def _ln_nobias(x, w, eps):
    """LayerNorm without a bias, in x's type (dbrx.py:78-81)."""
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean((x - m) ** 2, dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w


def forward(params: dict, cfg: DBRXConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (dbrx.py:84-135); the arguments as models/glm4moe.forward's."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    hd, c = cfg.head_dim, cfg.clamp_kqv
    cos, sin = rope_angles(positions, hd, cfg.rope_base)
    rows = cache_rows(cache_len, t, max_seq)
    keep = window_keep(positions, max_seq)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        h = _ln_nobias(x, params[pre + "attn_norm.weight"], cfg.eps)
        q, k, v = (_linear(h, params[pre + f"attn_{n}.weight"]) for n in "qkv")
        if c:
            q, k, v = (torch.clamp(z, -c, c) for z in (q, k, v))
        q = _rope_half(q.reshape(b, t, cfg.n_head, hd), cos, sin).transpose(1, 2)
        k = _rope_half(k.reshape(b, t, cfg.n_head_kv, hd), cos, sin).transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v.reshape(b, t, cfg.n_head_kv, hd).transpose(1, 2), cache_len, rows)
        out = gqa_attention(q, kc, vc, keep, hd ** -0.5)
        x = x + _linear(out.to(dt), params[pre + "attn_output.weight"])
        x = x + moe_ffn_block(params, pre, _ln_nobias(x, params[pre + "ffn_norm.weight"], cfg.eps), cfg)
    if not need_logits:
        return None, cache
    x = _ln_nobias(x, params["output_norm.weight"], cfg.eps)
    return _linear(x, params.get("output.weight", params["token_embd.weight"])), cache


class DBRX(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode
    (common.FamilyModel over dbrx.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a dbrx GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`), the stacked
        experts dequantized to `dtype`."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def dbrx_config() -> DBRXConfig:
    """DBRX at its published widths (databricks/dbrx-base config.json: vocab
    100352, d_model 6144, 40 blocks, 48 heads over kv_n_heads 8,
    ffn_hidden_size 10752, 16 experts, 4 a token (moe_normalize_expert_weights
    1: renormalized), clip_qkv 8, rope_theta 500000, max_seq_len 32768,
    LayerNorms without bias, eps 1e-5)."""
    return DBRXConfig(n_vocab=100352, n_ctx=32768, n_embd=6144, n_head=48, n_head_kv=8, n_layer=40, n_ff=10752,
                      n_expert=16, n_expert_used=4, rope_base=500000.0, clamp_kqv=8.0, eps=1e-5)


def write_random_gguf(path, cfg: DBRXConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write a dbrx file with the tensors the JAX forward reads (q, k and v
    apart; norms of ones without biases; an F32 router ffn_gate_inp (E, D);
    the stacked experts (E, n_ff, D) and (E, D, n_ff)) and the keys
    config_from_gguf reads (random_gguf.write_family_gguf: types,
    default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, e, f, nkv = cfg.n_embd, cfg.n_expert, cfg.n_ff, cfg.n_head_kv * cfg.head_dim
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("block_count", cfg.n_layer), ("feed_forward_length", f), ("expert_count", e),
            ("expert_used_count", cfg.n_expert_used), ("rope.freq_base", float(cfg.rope_base)),
            ("attention.clamp_kqv", float(cfg.clamp_kqv)), ("attention.layer_norm_epsilon", float(cfg.eps))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_q.weight", (d, d), "w"),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_v.weight", (nkv, d), "w"),
                    (pre + "attn_output.weight", (d, d), "w"), (pre + "ffn_norm.weight", (d,), "ones"),
                    (pre + "ffn_gate_inp.weight", (e, d), 0.02), (pre + "ffn_gate_exps.weight", (e, f, d), "w"),
                    (pre + "ffn_up_exps.weight", (e, f, d), "w"), (pre + "ffn_down_exps.weight", (e, d, f), "w")]
    write_family_gguf(path, "dbrx", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
