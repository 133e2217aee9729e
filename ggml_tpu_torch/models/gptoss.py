"""The GPT-OSS family (llama.cpp arch 'gpt-oss', OpenAI's open-weight
mixture of experts) in PyTorch: attention sinks (a learned logit a head that
joins the softmax and whose mass is dropped), sliding-window attention on
the even layers and full attention on the odd ones, biased q/k/v/o, YaRN
rotate-half RoPE, and in every layer experts with per-expert biases behind
the clamped SwiGLU (gate capped at the limit, up clamped both ways, (up + 1)
gate sigmoid(alpha gate)), routed by a biased router whose softmax runs
over the top-k logits.

Port of ggml_tpu/models/gptoss.py.  Below 16 tokens the experts run as the
gate-masked sum over every expert, from 16 as grouped products over the
(token, expert) pairs sorted by expert (models/llama.grouped_matmul: bf16
experts on the card) with each sorted row's biases gathered by its expert,
as GGML_TPU_MOE_GROUPED reads (auto; 1 always grouped, 0 never).  Attention
is plain f32 PyTorch over the whole cache window (models/common.
gqa_attention with sinks); the RoPE is the llama family's
(models/llama._rope_half_angles: none, linear or YaRN).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     linear as _linear, window_keep)
from .llama import _rms_norm, _rope_half, _rope_half_angles, add_back, grouped_matmul, moe_topk, sort_by_expert


@dataclass(frozen=True)
class GptOssConfig:
    n_vocab: int = 201088
    n_ctx: int = 131072
    n_embd: int = 2880
    n_head: int = 64
    n_head_kv: int = 8
    head_dim: int = 64
    n_layer: int = 24
    n_ff: int = 2880
    n_expert: int = 32
    n_expert_used: int = 4
    sliding_window: int = 128
    rope_base: float = 150000.0
    rope_scaling: str = "none"
    rope_scale: float = 1.0
    n_ctx_orig: int = 0
    rms_eps: float = 1e-5
    swiglu_limit: float = 7.0
    swiglu_alpha: float = 1.702


def config_from_gguf(g: GGUFFile) -> GptOssConfig:
    """The gpt-oss.* metadata with the JAX reader's keys and defaults
    (gptoss.py:56-80)."""
    md = g.metadata
    a = "gpt-oss"
    n_head = int(md[f"{a}.attention.head_count"])
    return GptOssConfig(
        n_vocab=int(md[f"{a}.vocab_size"]),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        head_dim=int(md.get(f"{a}.attention.key_length", int(md[f"{a}.embedding_length"]) // n_head)),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_expert=int(md[f"{a}.expert_count"]),
        n_expert_used=int(md[f"{a}.expert_used_count"]),
        sliding_window=int(md.get(f"{a}.attention.sliding_window", 128)),
        rope_base=float(md.get(f"{a}.rope.freq_base", 150000.0)),
        rope_scaling=str(md.get(f"{a}.rope.scaling.type", "none")),
        rope_scale=float(md.get(f"{a}.rope.scaling.factor", 1.0)),
        n_ctx_orig=int(md.get(f"{a}.rope.scaling.original_context_length", 0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
    )


def init_cache(cfg: GptOssConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def _oai_glu(gate, up, limit: float, alpha: float):
    """The clamped SwiGLU (gptoss.py:83-88): gate capped above, up clamped
    both ways, (up + 1) gate sigmoid(alpha gate)."""
    gate = torch.clamp(gate, max=limit)
    up = torch.clamp(up, -limit, limit)
    return (up + 1.0) * gate * torch.sigmoid(alpha * gate)


def moe_block(params: dict, pre: str, h, cfg: GptOssConfig):
    """The router (a biased linear, softmax over the top-k logits) and the
    experts with their biases (gptoss.py:91-118): ffn_{gate,up}_exps (E, F,
    D) with .bias (E, F), ffn_down_exps (E, D, F) with .bias (E, D).  Below
    16 tokens every expert's product, the gate-masked sum; from 16 the
    grouped products (_moe_grouped)."""
    with torch.profiler.record_function("gptoss.router"):
        router = _linear(h, params[pre + "ffn_gate_inp.weight"]) + params[pre + "ffn_gate_inp.bias"]
        probs, idx = moe_topk(router, cfg.n_expert_used)
    w_gate, b_gate = params[pre + "ffn_gate_exps.weight"], params[pre + "ffn_gate_exps.bias"]
    w_up, b_up = params[pre + "ffn_up_exps.weight"], params[pre + "ffn_up_exps.bias"]
    w_down, b_down = params[pre + "ffn_down_exps.weight"], params[pre + "ffn_down_exps.bias"]
    mode = os.environ.get("GGML_TPU_MOE_GROUPED", "auto")
    with torch.profiler.record_function("gptoss.moe_experts"):
        if mode == "1" or (mode == "auto" and h.shape[0] * h.shape[1] >= 16):
            return _moe_grouped(h, w_gate, b_gate, w_up, b_up, w_down, b_down, probs, idx, cfg)
        lead, d = h.shape[:-1], h.shape[-1]
        e, f = w_gate.shape[0], w_gate.shape[1]
        gates = torch.zeros((*probs.shape[:-1], e), dtype=torch.float32, device=h.device).scatter(-1, idx, probs)
        x = h.reshape(-1, d).to(w_gate.dtype)
        hg = torch.matmul(x, w_gate.reshape(e * f, d).t()).view(-1, e, f) + b_gate
        hu = torch.matmul(x.to(w_up.dtype), w_up.reshape(e * f, d).t()).view(-1, e, f) + b_up
        y = _oai_glu(hg, hu, cfg.swiglu_limit, cfg.swiglu_alpha)
        y = torch.matmul(y.transpose(0, 1), w_down.to(y.dtype).transpose(1, 2)) + b_down[:, None, :]  # (E, n, D)
        out = torch.einsum("end,ne->nd", y, gates.reshape(-1, e).to(y.dtype))
        return out.reshape(*lead, d).to(h.dtype)


def _moe_grouped(h, w_gate, b_gate, w_up, b_up, w_down, b_down, probs, idx, cfg: GptOssConfig):
    """The grouped experts (gptoss.py:121-145): the pairs sorted by expert,
    the three products grouped over the sorted rows, each row's expert
    biases gathered by its expert and added before the clamped SwiGLU and
    after the down product, then the rows weighted and added back."""
    b, t, d = h.shape
    k = idx.shape[-1]
    n = b * t
    order, tok, offs = sort_by_expert(idx, cfg.n_expert)
    e_sorted = idx.reshape(n * k)[order]
    xs = h.reshape(n, d)[tok].to(w_gate.dtype)
    hg = grouped_matmul(xs, w_gate, offs) + b_gate[e_sorted]
    hu = grouped_matmul(xs, w_up.to(xs.dtype), offs) + b_up[e_sorted]
    y = _oai_glu(hg, hu, cfg.swiglu_limit, cfg.swiglu_alpha)
    down = grouped_matmul(y, w_down.to(y.dtype), offs) + b_down[e_sorted]
    rows = down * probs.reshape(n * k)[order][:, None].to(down.dtype)
    return add_back(rows, order, n, k).reshape(b, t, d).to(h.dtype)


def forward(params: dict, cfg: GptOssConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (gptoss.py:155-224); the arguments as models/glm4moe.forward's.
    The even layers attend the keys at kv_pos > q_pos - sliding_window too,
    every layer with its sinks."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    hd = cfg.head_dim
    cos, sin = _rope_half_angles(positions, cfg)
    rows = cache_rows(cache_len, t, max_seq)
    keep = (window_keep(positions, max_seq, cfg.sliding_window), window_keep(positions, max_seq))
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
        q = _linear(h, params[pre + "attn_q.weight"], params[pre + "attn_q.bias"]).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"], params[pre + "attn_k.bias"]).reshape(b, t, cfg.n_head_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"], params[pre + "attn_v.bias"]).reshape(b, t, cfg.n_head_kv, hd)
        q, k = _rope_half(q, cos, sin).transpose(1, 2), _rope_half(k, cos, sin).transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(q, kc, vc, keep[i % 2], hd ** -0.5,
                            sinks=params[pre + "attn_sinks.weight"])
        x = x + _linear(out.to(dt), params[pre + "attn_output.weight"], params[pre + "attn_output.bias"])
        x = x + moe_block(params, pre, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps), cfg)
    if not need_logits:
        return None, cache
    x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
    return _linear(x, params.get("output.weight", params["token_embd.weight"])), cache


class GptOss(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode
    (common.FamilyModel over gptoss.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a gpt-oss GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`), the stacked
        experts dequantized to `dtype` (bf16 by default: the grouped
        products on the card take bf16 only)."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def gpt_oss_20b_config() -> GptOssConfig:
    """gpt-oss-20b at its published widths (openai/gpt-oss-20b config.json:
    vocab 201088, hidden 2880, 24 layers, 64 heads over 8 kv heads,
    head_dim 64, 32 experts of intermediate_size 2880, 4 a token,
    sliding_window 128 on the even layers, rope_theta 150000 with YaRN
    factor 32 over original_max_position_embeddings 4096 (beta_fast 32,
    beta_slow 1), 131072 positions, swiglu_limit 7.0, rms_norm_eps 1e-5)."""
    return GptOssConfig(n_vocab=201088, n_ctx=131072, n_embd=2880, n_head=64, n_head_kv=8, head_dim=64,
                        n_layer=24, n_ff=2880, n_expert=32, n_expert_used=4, sliding_window=128,
                        rope_base=150000.0, rope_scaling="yarn", rope_scale=32.0, n_ctx_orig=4096, rms_eps=1e-5)


def write_random_gguf(path, cfg: GptOssConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K, sink_std: float = 1.0):
    """Write a gpt-oss file as llama.cpp's converter lays one out (its
    experts de-interleaved into stacked (E, F, D) gate and up tensors): the
    keys config_from_gguf reads (the rope scaling keys unless
    cfg.rope_scaling is "none"), biased q/k/v/o, attn_sinks (H,) of std
    sink_std, a biased F32 router ffn_gate_inp (E, D), the stacked experts
    with their F32 biases (E, F) and (E, D); norms of ones, biases of std
    0.02 (random_gguf.write_family_gguf: types, default_type, the fallbacks:
    at gpt-oss-20b's K = 2880, Q4_K becomes Q5_0 and Q6_K Q8_0)."""
    from .random_gguf import write_family_gguf

    d, e, f, hd = cfg.n_embd, cfg.n_expert, cfg.n_ff, cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("attention.key_length", hd), ("attention.value_length", hd), ("block_count", cfg.n_layer),
            ("feed_forward_length", f), ("expert_count", e), ("expert_used_count", cfg.n_expert_used),
            ("attention.sliding_window", cfg.sliding_window), ("rope.freq_base", float(cfg.rope_base)),
            ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps))]
    if cfg.rope_scaling not in ("none", ""):
        keys += [("rope.scaling.type", cfg.rope_scaling), ("rope.scaling.factor", float(cfg.rope_scale)),
                 ("rope.scaling.original_context_length", cfg.n_ctx_orig)]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"),
                    (pre + "attn_q.weight", (nq, d), "w"), (pre + "attn_q.bias", (nq,), 0.02),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_k.bias", (nkv,), 0.02),
                    (pre + "attn_v.weight", (nkv, d), "w"), (pre + "attn_v.bias", (nkv,), 0.02),
                    (pre + "attn_output.weight", (d, nq), "w"), (pre + "attn_output.bias", (d,), 0.02),
                    (pre + "attn_sinks.weight", (cfg.n_head,), sink_std), (pre + "ffn_norm.weight", (d,), "ones"),
                    (pre + "ffn_gate_inp.weight", (e, d), 0.02), (pre + "ffn_gate_inp.bias", (e,), 0.02),
                    (pre + "ffn_gate_exps.weight", (e, f, d), "w"), (pre + "ffn_gate_exps.bias", (e, f), 0.02),
                    (pre + "ffn_up_exps.weight", (e, f, d), "w"), (pre + "ffn_up_exps.bias", (e, f), 0.02),
                    (pre + "ffn_down_exps.weight", (e, d, f), "w"), (pre + "ffn_down_exps.bias", (e, d), 0.02)]
    write_family_gguf(path, "gpt-oss", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
