"""The DeepSeek V2/V3 family (llama.cpp arch 'deepseek2') in PyTorch:
multi-head latent attention (MLA) in the absorbed form, group-limited top-k
routing over sigmoid or softmax scores with shared experts, and leading
dense layers.

Port of ggml_tpu/models/deepseek.py.  The cache holds per layer only the
kv_lora_rank latent c_kv and the shared qk_rope_dim rope key (a (b, 1, S,
rank) and a (b, 1, S, rope) buffer, or QuantKV codes and row scales): 1152
bytes a token and layer in bf16 at rank 512 and rope 64.  Attention never
expands the keys or values per head: each head's non-rope query is
projected into the latent space through W_uk (q_eff = q_nope W_uk), the
scores are taken against the latent rows and the shared rope key in f32
over the whole cache window, and the context comes back out through W_uv;
attn_kv_b (H (nope + v), rank) is reshaped into W_uk and W_uv, so it stays
a dense tensor whatever the file's type.  The other linears go through
models/common.linear (planar_matmul's kernels over quantized planes).

Routing (deepseek_route) follows HF transformers' deepseek_v3: scores, plus
the exp_probs_b bias for the selection only; over n_group groups each
group scores the sum of its top-2, the topk_group best survive and the
others' experts score 0.0; the top k of what is left, their weights taken
from the scores without the bias, renormalized or not, times
routed_scale.  The experts run through the llama family's expert sums
(models/llama.moe_expert_sum below 16 tokens, moe_expert_sum_grouped from
16, as GGML_TPU_MOE_GROUPED reads), the shared experts as one SwiGLU every
token takes.  Every ranking breaks ties as jax.lax.top_k does
(models/llama.top_k).

The JAX package reads no YaRN keys (V2-Lite's rope_scaling is not applied
there either) and scores V2's group_limited_greedy as V3's top-2 sum; the
port follows it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (QUANT_KV_DTYPE, FamilyModel, LoRAWeight, QuantKV, cache_rows, cache_write, dequant_cache,
                     linear as _linear, run_layers)
from .gptj import rope_angles
from .llama import _rms_norm, _rope_half, moe_expert_sum, moe_expert_sum_grouped, top_k


@dataclass(frozen=True)
class DeepseekConfig:
    n_vocab: int = 32000
    n_ctx: int = 4096
    n_embd: int = 1024
    n_head: int = 16
    n_layer: int = 2
    n_ff: int = 4096
    n_dense_lead: int = 1  # first_k_dense_replace
    q_lora_rank: int = 0  # 0: a direct q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    n_expert: int = 0
    n_expert_used: int = 0
    n_shared: int = 2  # the shared experts' multiplier (the forward reads the widths from the tensors)
    n_group: int = 1
    topk_group: int = 1
    score_func: str = "sigmoid"  # V3; V2 uses softmax
    moe_renorm: bool = True
    routed_scale: float = 1.0
    rope_base: float = 10000.0
    rms_eps: float = 1e-6
    rope_interleave: bool = True  # HF checkpoints keep the rope dims interleaved
    attn_scale: float = 0.0  # 0: qk_head_dim ** -0.5

    @property
    def qk_head_dim(self):
        return self.qk_nope_dim + self.qk_rope_dim


def config_from_gguf(g: GGUFFile) -> DeepseekConfig:
    """The deepseek2.* metadata with the JAX reader's keys and defaults
    (deepseek.py:72-104); expert_gating_func 2 is sigmoid, anything else
    softmax."""
    md = g.metadata
    a = "deepseek2"
    gating = int(md.get(f"{a}.expert_gating_func", 1))
    return DeepseekConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 32000)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=int(md[f"{a}.attention.head_count"]),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_dense_lead=int(md.get(f"{a}.leading_dense_block_count", 0)),
        q_lora_rank=int(md.get(f"{a}.attention.q_lora_rank", 0)),
        kv_lora_rank=int(md[f"{a}.attention.kv_lora_rank"]),
        qk_rope_dim=int(md[f"{a}.rope.dimension_count"]),
        qk_nope_dim=int(md[f"{a}.attention.key_length"]) - int(md[f"{a}.rope.dimension_count"]),
        v_head_dim=int(md[f"{a}.attention.value_length"]),
        n_expert=int(md.get(f"{a}.expert_count", 0)),
        n_expert_used=int(md.get(f"{a}.expert_used_count", 0)),
        n_shared=int(md.get(f"{a}.expert_shared_count", 0)),
        n_group=int(md.get(f"{a}.expert_group_count", 1)),
        topk_group=int(md.get(f"{a}.expert_group_used_count", 1)),
        score_func="sigmoid" if gating == 2 else "softmax",
        moe_renorm=bool(md.get(f"{a}.expert_weights_norm", True)),
        routed_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-6)),
        rope_interleave=bool(md.get(f"{a}.rope_interleave", True)),
    )


def _deinterleave(x):
    """(..., d) interleaved rope pairs -> the rotate-half layout (HF
    apply_rotary_pos_emb_interleave's view and transpose)."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def deepseek_route(h, w_router, bias, cfg: DeepseekConfig):
    """Group-limited top-k routing (deepseek.py:114-139): h (b, t, D),
    w_router (E, D), bias (E,) -> (weights (b, t, k) f32, experts (b, t, k)).
    The router logits in f32; sigmoid or softmax scores; the bias added for
    the selection only.  With groups, a group's score is the sum of its two
    best, the topk_group best groups survive and every expert of the others
    scores 0.0 (as HF does, so with a negative bias a masked expert can
    outrank a surviving one).  Each of the three rankings puts the lower
    index first among equal values, as jax.lax.top_k does."""
    return route_logits(torch.matmul(h.float(), w_router.float().t()), bias, cfg)


def route_logits(logits, bias, cfg: DeepseekConfig):
    """deepseek_route from the f32 router logits (..., E) on."""
    scores = torch.sigmoid(logits) if cfg.score_func == "sigmoid" else torch.softmax(logits, dim=-1)
    choice = scores + bias.float()
    e, g = cfg.n_expert, cfg.n_group
    if g > 1:
        grouped = choice.reshape(*choice.shape[:-1], g, e // g)
        gscore = top_k(grouped, min(2, e // g))[0].sum(-1)  # (b, t, g)
        keep = torch.zeros_like(gscore).scatter(-1, top_k(gscore, cfg.topk_group)[1], 1.0)
        choice = torch.where(keep[..., None] > 0.5, grouped, 0.0).reshape(choice.shape)
    idx = top_k(choice, cfg.n_expert_used)[1]
    wts = scores.gather(-1, idx)
    if cfg.moe_renorm:
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    return wts * cfg.routed_scale, idx


def _moe_block(params: dict, pre: str, h, cfg: DeepseekConfig):
    """A MoE layer's FFN on its normed input (deepseek.py:142-161): the
    routed experts, below 16 tokens the gate-masked sum over all of them and
    from 16 the grouped sum over the chosen ones (GGML_TPU_MOE_GROUPED:
    auto, 1 always grouped, 0 never), plus the shared experts' SwiGLU."""
    with torch.profiler.record_function("deepseek.router"):
        wts, idx = deepseek_route(h, params[pre + "ffn_gate_inp.weight"], params[pre + "exp_probs_b.bias"], cfg)
    w_gate = params[pre + "ffn_gate_exps.weight"]
    w_up = params[pre + "ffn_up_exps.weight"]
    w_down = params[pre + "ffn_down_exps.weight"]
    mode = os.environ.get("GGML_TPU_MOE_GROUPED", "auto")
    with torch.profiler.record_function("deepseek.moe_experts"):
        if mode == "1" or (mode == "auto" and h.shape[0] * h.shape[1] >= 16):
            out = moe_expert_sum_grouped(h, w_gate, w_up, w_down, wts, idx, cfg.n_expert)
        else:
            gates = torch.zeros((*wts.shape[:-1], cfg.n_expert), dtype=torch.float32, device=h.device)
            out = moe_expert_sum(h, w_gate, w_up, w_down, gates.scatter(-1, idx, wts))
    gate = _linear(h, params[pre + "ffn_gate_shexp.weight"])
    up = _linear(h, params[pre + "ffn_up_shexp.weight"])
    return out + _linear(F.silu(gate) * up, params[pre + "ffn_down_shexp.weight"])


def init_cache(cfg: DeepseekConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    """Per layer (c_kv (b, 1, S, kv_lora_rank), k_rot (b, 1, S, qk_rope_dim))
    (deepseek.py:164-184); dtype="q8_kv" makes both QuantKV (int8 codes and
    one f32 scale a row)."""
    def mk(d):
        if dtype == QUANT_KV_DTYPE:
            return QuantKV(torch.zeros((batch, 1, max_seq, d), dtype=torch.int8, device=device),
                           torch.zeros((batch, 1, max_seq, 1), dtype=torch.float32, device=device))
        return torch.zeros((batch, 1, max_seq, d), dtype=dtype, device=device)

    return [(mk(cfg.kv_lora_rank), mk(cfg.qk_rope_dim)) for _ in range(cfg.n_layer)]


def _dense(w, dt):
    """A weight the forward reshapes (attn_kv_b) as a dense tensor in the
    promoted type, as the JAX einsum meets its operands."""
    if isinstance(w, LoRAWeight) or not isinstance(w, torch.Tensor):
        raise TypeError(f"attn_kv_b is reshaped into the per-head W_uk and W_uv, so it must be a dense tensor, not "
                        f"{type(w).__name__} (a quantized attn_kv_b is loaded dense by Deepseek.from_gguf)")
    return w.to(torch.promote_types(w.dtype, dt))


def mla_attention(q_pass, q_rot, c_all, krot_all, w_kv_b, visible, cfg: DeepseekConfig, dt):
    """The absorbed attention (deepseek.py:233-252): q_pass (b, t, H, nope)
    and q_rot (b, t, H, rope) against the latent rows c_all (b, S, rank) and
    the rope keys krot_all (b, S, rope), visible (b, t, 1, S) the rows each
    query sees.  q_eff = q_pass W_uk and o = ctx W_uv are products of the
    model's type; the scores, the softmax and the context run in f32.
    Returns (b, t, H * v) in dt."""
    b, t, n_head, nope = q_pass.shape
    r, s = c_all.shape[-1], c_all.shape[1]
    w_kv_b = _dense(w_kv_b, q_pass.dtype).reshape(n_head, nope + cfg.v_head_dim, r)
    w_uk, w_uv = w_kv_b[:, :nope, :], w_kv_b[:, nope:, :]
    q_eff = torch.einsum("bthn,hnr->bthr", q_pass.to(w_uk.dtype), w_uk)
    cf = c_all.float()
    att = (torch.matmul(q_eff.float().reshape(b, t * n_head, r), cf.transpose(1, 2))
           + torch.matmul(q_rot.float().reshape(b, t * n_head, -1), krot_all.float().transpose(1, 2)))
    scale = cfg.attn_scale or cfg.qk_head_dim ** -0.5
    att = torch.where(visible, att.view(b, t, n_head, s) * scale, torch.full((), float("-inf"), device=att.device))
    att = torch.softmax(att, dim=-1)
    ctx = torch.matmul(att.view(b, t * n_head, s), cf).view(b, t, n_head, r).to(dt)
    o = torch.einsum("bthr,hvr->bthv", ctx.to(w_uv.dtype), w_uv)
    return o.reshape(b, t, n_head * cfg.v_head_dim)


def _swiglu(params: dict, pre: str, h):
    gate = _linear(h, params[pre + "ffn_gate.weight"])
    up = _linear(h, params[pre + "ffn_up.weight"])
    return _linear(F.silu(gate) * up, params[pre + "ffn_down.weight"])


def ffn_block(params: dict, pre: str, i: int, h, cfg: DeepseekConfig):
    """Layer i's FFN on its normed input: the dense SwiGLU in the leading
    dense layers (or a model without experts), else the MoE block."""
    if i < cfg.n_dense_lead or cfg.n_expert == 0:
        return _swiglu(params, pre, h)
    return _moe_block(params, pre, h, cfg)


def attention_inputs(params: dict, pre: str, h, cos, sin, cfg: DeepseekConfig):
    """A layer's projections on its normed input h (b, t, D): (q_pass (b, t,
    H, nope), q_rot (b, t, H, rope) after RoPE, the normed latent c_t (b, t,
    rank), the rope key k_rot (b, t, rope) after RoPE); the q projection
    direct or through attn_q_a, its norm and attn_q_b; the rope dims
    de-interleaved first where the file keeps them interleaved."""
    b, t = h.shape[:2]
    if cfg.q_lora_rank:
        qa = _rms_norm(_linear(h, params[pre + "attn_q_a.weight"]), params[pre + "attn_q_a_norm.weight"], cfg.rms_eps)
        q = _linear(qa, params[pre + "attn_q_b.weight"])
    else:
        q = _linear(h, params[pre + "attn_q.weight"])
    q = q.reshape(b, t, cfg.n_head, cfg.qk_head_dim)
    q_pass, q_rot = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    ckv = _linear(h, params[pre + "attn_kv_a_mqa.weight"])
    c_t, krot = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c_t = _rms_norm(c_t, params[pre + "attn_kv_a_norm.weight"], cfg.rms_eps)
    if cfg.rope_interleave:
        q_rot, krot = _deinterleave(q_rot), _deinterleave(krot)
    return q_pass, _rope_half(q_rot, cos, sin), c_t, _rope_half(krot[:, :, None, :], cos, sin)[:, :, 0, :]


def final_logits(params: dict, x, cfg: DeepseekConfig, w_out):
    """The final RMSNorm and the head w_out."""
    return _linear(_rms_norm(x, params["output_norm.weight"], cfg.rms_eps), w_out)


def forward(params: dict, cfg: DeepseekConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache); the latent rows are
    written in place and the cache returned (deepseek.py:187-266).

    pos_start (b,) and cache_len (0-d, or (b,): a position per row) are
    integer tensors on the model's device.  Every step attends over the
    whole cache window (there is no flash path: prefill is accepted and
    changes nothing).  need_logits=False skips the final norm and the head
    (serve.Engine's admission); layer_remat: each layer rematerialized
    (common.run_layers)."""
    b, t = tokens.shape
    dev = tokens.device
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=dev)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_base)
    rows = cache_rows(cache_len, t, max_seq)
    visible = torch.arange(max_seq, device=dev)[None, None, None, :] <= positions[:, :, None, None]

    def layer(i, x):
        pre = f"blk.{i}."
        h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
        q_pass, q_rot, c_t, krot = attention_inputs(params, pre, h, cos, sin, cfg)
        cc, kc = cache[i]
        cache_write(cc, c_t[:, None], cache_len, rows)
        cache_write(kc, krot[:, None], cache_len, rows)
        with torch.profiler.record_function("deepseek.attention"):
            o = mla_attention(q_pass, q_rot, dequant_cache(cc)[:, 0], dequant_cache(kc)[:, 0],
                              params[pre + "attn_kv_b.weight"], visible, cfg, dt)
        x = x + _linear(o, params[pre + "attn_output.weight"])
        return x + ffn_block(params, pre, i, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps), cfg)

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    return final_logits(params, x, cfg, params.get("output.weight", params["token_embd.weight"])), cache


class Deepseek(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode (the
    JAX Deepseek, with the port's DecodeGraph and decode_sampled:
    common.FamilyModel over deepseek.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a deepseek2 GGUF file onto `device`: its quantized 2-D
        weights stay planes (keep_quantized=False: every tensor dequantized
        to `dtype`), the stacked experts and attn_kv_b are dequantized to
        `dtype` (the forward reshapes attn_kv_b, which the JAX package's
        from_gguf keeps dense for that reason)."""
        from ..quant.planar import PlanarWeight
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            for name, w in params.items():
                if name.endswith("attn_kv_b.weight") and isinstance(w, PlanarWeight):
                    params[name] = torch.from_numpy(g.to_float32(name)).to(device, dtype)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def deepseek_v2_lite_config() -> DeepseekConfig:
    """DeepSeek-V2-Lite at its published widths (deepseek-ai/DeepSeek-V2-Lite
    config.json: vocab 102400, hidden 2048, 27 layers, 16 heads, no q_lora,
    kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128, intermediate 10944,
    first_k_dense_replace 1, 64 routed experts of moe_intermediate_size 1408
    with 2 shared, 6 a token, n_group 1, softmax scores, norm_topk_prob
    false, routed_scaling_factor 1.0, rope_theta 10000, rms_norm_eps 1e-6,
    163840 positions).  Its YaRN rope_scaling is not read (as in JAX); the
    experts' width is their tensors' (write_random_gguf's n_ff_exp)."""
    return DeepseekConfig(n_vocab=102400, n_ctx=163840, n_embd=2048, n_head=16, n_layer=27, n_ff=10944,
                          n_dense_lead=1, q_lora_rank=0, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                          v_head_dim=128, n_expert=64, n_expert_used=6, n_shared=2, n_group=1, topk_group=1,
                          score_func="softmax", moe_renorm=False, routed_scale=1.0, rope_base=10000.0, rms_eps=1e-6)


def deepseek_v3_config() -> DeepseekConfig:
    """DeepSeek-V3 at its published widths (deepseek-ai/DeepSeek-V3
    config.json: vocab 129280, hidden 7168, 61 layers, 128 heads,
    q_lora_rank 1536, kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128,
    intermediate 18432, first_k_dense_replace 3, 256 routed experts of
    moe_intermediate_size 2048 with 1 shared, 8 a token, n_group 8,
    topk_group 4, sigmoid scores with e_score_correction_bias,
    norm_topk_prob true, routed_scaling_factor 2.5, rope_theta 10000,
    rms_norm_eps 1e-6, 163840 positions)."""
    return DeepseekConfig(n_vocab=129280, n_ctx=163840, n_embd=7168, n_head=128, n_layer=61, n_ff=18432,
                          n_dense_lead=3, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                          v_head_dim=128, n_expert=256, n_expert_used=8, n_shared=1, n_group=8, topk_group=4,
                          score_func="sigmoid", moe_renorm=True, routed_scale=2.5, rope_base=10000.0, rms_eps=1e-6)


def write_random_gguf(path, cfg: DeepseekConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, n_ff_exp: int | None = None,
                      default_type: GGMLType = GGMLType.Q4_K, bias_std: float = 0.0):
    """Write a deepseek2 GGUF file as llama.cpp's converter lays one out: the
    deepseek2.* keys config_from_gguf reads (no YaRN keys), the MLA tensors
    (attn_q, or attn_q_a, attn_q_a_norm and attn_q_b; attn_kv_a_mqa,
    attn_kv_a_norm, attn_kv_b, attn_output), in the first n_dense_lead
    layers the SwiGLU ffn_{gate,up,down}, in the others an F32 router
    ffn_gate_inp (E, D), an F32 exp_probs_b.bias (E,) drawn from normal(0,
    bias_std) (zeros at 0), the stacked experts ffn_{gate,up}_exps (E,
    n_ff_exp, D) and ffn_down_exps (E, D, n_ff_exp) (n_ff_exp: cfg.n_ff by
    default) and the shared experts ffn_*_shexp of width n_shared * n_ff_exp;
    norms of ones.

    types: a map from tensor names to types; default_type for a weight it
    does not name.  A Q4_K or Q6_K weight whose K is not a multiple of 256
    takes llama.cpp's fallback (Q4_K -> Q5_0, Q6_K -> Q8_0): at
    DeepSeek-V2-Lite's widths the dense ffn_down (K = 10944) and
    ffn_down_exps (K = 1408).  F32: normal values of std 0.02; other types
    random blocks of weights of std about 0.02 (models/gptj.
    _random_weight_blocks), drawn and written by random_gguf.
    write_family_gguf.  tokenizer: GGUF tokenizer.ggml.* keys (without
    the prefix) -> values."""
    from .random_gguf import write_family_gguf

    n_ff_exp = n_ff_exp or cfg.n_ff
    keys = [("context_length", cfg.n_ctx), ("embedding_length", cfg.n_embd), ("block_count", cfg.n_layer),
            ("feed_forward_length", cfg.n_ff), ("attention.head_count", cfg.n_head),
            ("attention.head_count_kv", cfg.n_head), ("vocab_size", cfg.n_vocab)]
    if cfg.q_lora_rank:
        keys.append(("attention.q_lora_rank", cfg.q_lora_rank))
    keys += [("attention.kv_lora_rank", cfg.kv_lora_rank), ("attention.key_length", cfg.qk_head_dim),
             ("attention.value_length", cfg.v_head_dim), ("rope.dimension_count", cfg.qk_rope_dim),
             ("leading_dense_block_count", cfg.n_dense_lead), ("expert_count", cfg.n_expert),
             ("expert_used_count", cfg.n_expert_used), ("expert_shared_count", cfg.n_shared),
             ("expert_feed_forward_length", n_ff_exp), ("expert_group_count", cfg.n_group),
             ("expert_group_used_count", cfg.topk_group),
             ("expert_gating_func", 2 if cfg.score_func == "sigmoid" else 1),
             ("rope.freq_base", float(cfg.rope_base)), ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps)),
             ("expert_weights_norm", bool(cfg.moe_renorm)), ("expert_weights_scale", float(cfg.routed_scale)),
             ("rope_interleave", bool(cfg.rope_interleave))]
    d, H, r = cfg.n_embd, cfg.n_head, cfg.kv_lora_rank
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "ffn_norm.weight", (d,), "ones")]
        if cfg.q_lora_rank:
            tensors += [(pre + "attn_q_a.weight", (cfg.q_lora_rank, d), "w"),
                        (pre + "attn_q_a_norm.weight", (cfg.q_lora_rank,), "ones"),
                        (pre + "attn_q_b.weight", (H * cfg.qk_head_dim, cfg.q_lora_rank), "w")]
        else:
            tensors.append((pre + "attn_q.weight", (H * cfg.qk_head_dim, d), "w"))
        tensors += [(pre + "attn_kv_a_mqa.weight", (r + cfg.qk_rope_dim, d), "w"),
                    (pre + "attn_kv_a_norm.weight", (r,), "ones"),
                    (pre + "attn_kv_b.weight", (H * (cfg.qk_nope_dim + cfg.v_head_dim), r), "w"),
                    (pre + "attn_output.weight", (d, H * cfg.v_head_dim), "w")]
        if i < cfg.n_dense_lead or cfg.n_expert == 0:
            tensors += [(pre + "ffn_gate.weight", (cfg.n_ff, d), "w"), (pre + "ffn_up.weight", (cfg.n_ff, d), "w"),
                        (pre + "ffn_down.weight", (d, cfg.n_ff), "w")]
            continue
        n_sh = cfg.n_shared * n_ff_exp
        tensors += [(pre + "ffn_gate_inp.weight", (cfg.n_expert, d), 0.02),
                    (pre + "exp_probs_b.bias", (cfg.n_expert,), float(bias_std)),
                    (pre + "ffn_gate_exps.weight", (cfg.n_expert, n_ff_exp, d), "w"),
                    (pre + "ffn_up_exps.weight", (cfg.n_expert, n_ff_exp, d), "w"),
                    (pre + "ffn_down_exps.weight", (cfg.n_expert, d, n_ff_exp), "w"),
                    (pre + "ffn_gate_shexp.weight", (n_sh, d), "w"), (pre + "ffn_up_shexp.weight", (n_sh, d), "w"),
                    (pre + "ffn_down_shexp.weight", (d, n_sh), "w")]
    write_family_gguf(path, "deepseek2", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
