"""The GLM-4-MoE family (llama.cpp archs 'glm4moe', GLM-4.5 and GLM-4.6, and
'dots1', rednote dots.llm1) in PyTorch: grouped-query attention with biased
q/k/v, partial rotate-half RoPE and optional per-head q/k RMSNorm; the first
`first_dense` layers a dense SwiGLU, the others DeepSeek's routed mixture
of experts (sigmoid scores, the exp_probs_b correction bias for the
selection only, group-limited top-k, renormalized or not, a routed scale)
plus the shared expert every token takes.

Port of ggml_tpu/models/glm4moe.py.  The routing and the experts are
models/deepseek._moe_block's (below 16 tokens the gate-masked sum over every
expert, from 16 the grouped sum over the chosen ones), so the config carries
every field deepseek_route reads.  Attention runs in plain f32 PyTorch over
the whole cache window (models/common.gqa_attention), as the JAX forward
does in einsums; the linears go through models/common.linear (the
planar_matmul kernels over quantized planes).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     linear as _linear, window_keep)
from .deepseek import _moe_block
from .llama import _rms_norm
from .phi2 import _rope_half_partial, partial_angles


@dataclass(frozen=True)
class GLM4MoEConfig:
    n_vocab: int = 151552
    n_ctx: int = 131072
    n_embd: int = 4096
    n_head: int = 96
    n_head_kv: int = 8
    head_dim: int = 128
    n_layer: int = 46
    n_ff: int = 10944  # the dense layers'
    n_rot: int = 64
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    qk_norm: bool = False  # per-head (head_dim,) RMSNorm
    first_dense: int = 1  # first_k_dense_replace
    # what deepseek_route and _moe_block read
    n_expert: int = 128
    n_expert_used: int = 8
    n_group: int = 1
    topk_group: int = 1
    score_func: str = "sigmoid"
    moe_renorm: bool = True
    routed_scale: float = 1.0


def config_from_gguf(g: GGUFFile) -> GLM4MoEConfig:
    """The glm4moe.* or dots1.* metadata with the JAX reader's keys and
    defaults (glm4moe.py:54-88): dots1 files carry a full-dim rope
    (rope.dimension_count = head_dim), per-head q/k norms and their own
    expert_weights_norm and expert_weights_scale; expert_gating_func 2 is
    sigmoid, anything else softmax."""
    md = g.metadata
    a = md.get("general.architecture", "glm4moe")
    if a not in ("glm4moe", "dots1"):
        a = "glm4moe"
    n_head = int(md[f"{a}.attention.head_count"])
    n_embd = int(md[f"{a}.embedding_length"])
    head_dim = int(md.get(f"{a}.attention.key_length", n_embd // n_head))
    gating = int(md.get(f"{a}.expert_gating_func", 2))
    return GLM4MoEConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 151552)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=n_embd,
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        head_dim=head_dim,
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_rot=int(md.get(f"{a}.rope.dimension_count", head_dim // 2)),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
        qk_norm="blk.0.attn_q_norm.weight" in g.tensors,
        first_dense=int(md.get(f"{a}.leading_dense_block_count", 1)),
        n_expert=int(md[f"{a}.expert_count"]),
        n_expert_used=int(md[f"{a}.expert_used_count"]),
        n_group=int(md.get(f"{a}.expert_group_count", 1)),
        topk_group=int(md.get(f"{a}.expert_group_used_count", 1)),
        score_func="sigmoid" if gating == 2 else "softmax",
        routed_scale=float(md.get(f"{a}.expert_weights_scale", 1.0)),
        moe_renorm=bool(md.get(f"{a}.expert_weights_norm", True)),
    )


def init_cache(cfg: GLM4MoEConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def forward(params: dict, cfg: GLM4MoEConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache); the cache rows are
    written in place and the cache returned (glm4moe.py:98-159).  pos_start
    (b,) and cache_len (0-d, or (b,): a position per row) are integer
    tensors on the model's device.  Every step attends over the whole cache
    window (prefill changes nothing).  need_logits=False skips the final
    norm and the head (serve.Engine's admission)."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    hd = cfg.head_dim
    cos, sin = partial_angles(positions, cfg.n_rot, cfg.rope_base)
    rows = cache_rows(cache_len, t, max_seq)
    keep = window_keep(positions, max_seq)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
        q = _linear(h, params[pre + "attn_q.weight"], params.get(pre + "attn_q.bias")).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"], params.get(pre + "attn_k.bias")).reshape(b, t, cfg.n_head_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"], params.get(pre + "attn_v.bias")).reshape(b, t, cfg.n_head_kv, hd)
        if cfg.qk_norm:  # per-head RMSNorm over head_dim, before RoPE
            q = _rms_norm(q, params[pre + "attn_q_norm.weight"], cfg.rms_eps)
            k = _rms_norm(k, params[pre + "attn_k_norm.weight"], cfg.rms_eps)
        q = _rope_half_partial(q, cos, sin, cfg.n_rot).transpose(1, 2)
        k = _rope_half_partial(k, cos, sin, cfg.n_rot).transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(q, kc, vc, keep, hd ** -0.5)
        x = x + _linear(out.to(dt), params[pre + "attn_output.weight"])
        h = _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps)
        if i < cfg.first_dense:
            gate = _linear(h, params[pre + "ffn_gate.weight"])
            up = _linear(h, params[pre + "ffn_up.weight"])
            x = x + _linear(F.silu(gate) * up, params[pre + "ffn_down.weight"])
        else:
            x = x + _moe_block(params, pre, h, cfg)
    if not need_logits:
        return None, cache
    x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
    return _linear(x, params.get("output.weight", params["token_embd.weight"])), cache


class GLM4MoE(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode
    (common.FamilyModel over glm4moe.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a glm4moe or dots1 GGUF file onto `device`: its quantized 2-D
        weights stay planes (keep_quantized=False: every tensor dequantized
        to `dtype`), the stacked experts are dequantized to `dtype`."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def glm45_air_config() -> GLM4MoEConfig:
    """GLM-4.5-Air at its published widths (zai-org/GLM-4.5-Air config.json:
    vocab 151552, hidden 4096, 46 layers, 96 heads over 8 kv heads,
    head_dim 128, partial_rotary_factor 0.5, attention_bias true, use_qk_norm
    false, intermediate 10944, first_k_dense_replace 1, 128 routed experts
    of moe_intermediate_size 1408 with 1 shared, 8 a token, n_group 1,
    sigmoid scores with e_score_correction_bias, norm_topk_prob true,
    routed_scaling_factor 1.0, rope_theta 1e6, rms_norm_eps 1e-5, 131072
    positions).  The experts' width is their tensors' (write_random_gguf's
    n_ff_exp)."""
    return GLM4MoEConfig(n_vocab=151552, n_ctx=131072, n_embd=4096, n_head=96, n_head_kv=8, head_dim=128,
                         n_layer=46, n_ff=10944, n_rot=64, rope_base=1e6, rms_eps=1e-5, qk_norm=False, first_dense=1,
                         n_expert=128, n_expert_used=8, n_group=1, topk_group=1, score_func="sigmoid",
                         moe_renorm=True, routed_scale=1.0)


def write_random_gguf(path, cfg: GLM4MoEConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, arch: str = "glm4moe", n_ff_exp: int | None = None,
                      n_shared: int = 1, default_type: GGMLType = GGMLType.Q4_K, bias_std: float = 0.0):
    """Write a glm4moe (biased q/k/v) or dots1 file as llama.cpp's converter
    lays one out: the keys config_from_gguf reads; per-head q/k norms where
    cfg.qk_norm; in the first cfg.first_dense layers the SwiGLU
    ffn_{gate,up,down} of width cfg.n_ff, in the others an F32 router
    ffn_gate_inp (E, D), an F32 exp_probs_b.bias (E,) of std bias_std
    (zeros at 0), the stacked experts ffn_{gate,up}_exps (E, n_ff_exp, D)
    and ffn_down_exps (E, D, n_ff_exp) (n_ff_exp: cfg.n_ff by default) and
    the shared experts ffn_*_shexp of width n_shared * n_ff_exp; norms of
    ones, biases of std 0.02.  types, default_type and the fallbacks of
    random_gguf.write_family_gguf; tokenizer: tokenizer.ggml.* keys."""
    from .random_gguf import write_family_gguf

    n_ff_exp = n_ff_exp or cfg.n_ff
    d, hd, nq, nkv = cfg.n_embd, cfg.head_dim, cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("attention.key_length", hd), ("attention.value_length", hd), ("block_count", cfg.n_layer),
            ("feed_forward_length", cfg.n_ff), ("rope.dimension_count", cfg.n_rot),
            ("rope.freq_base", float(cfg.rope_base)), ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps)),
            ("leading_dense_block_count", cfg.first_dense), ("expert_count", cfg.n_expert),
            ("expert_used_count", cfg.n_expert_used), ("expert_group_count", cfg.n_group),
            ("expert_group_used_count", cfg.topk_group),
            ("expert_gating_func", 2 if cfg.score_func == "sigmoid" else 1),
            ("expert_weights_scale", float(cfg.routed_scale)), ("expert_weights_norm", cfg.moe_renorm),
            ("expert_feed_forward_length", n_ff_exp), ("expert_shared_count", n_shared)]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_q.weight", (nq, d), "w"),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_v.weight", (nkv, d), "w")]
        if arch == "glm4moe":
            tensors += [(pre + "attn_q.bias", (nq,), 0.02), (pre + "attn_k.bias", (nkv,), 0.02),
                        (pre + "attn_v.bias", (nkv,), 0.02)]
        if cfg.qk_norm:
            tensors += [(pre + "attn_q_norm.weight", (hd,), "ones"), (pre + "attn_k_norm.weight", (hd,), "ones")]
        tensors += [(pre + "attn_output.weight", (d, nq), "w"), (pre + "ffn_norm.weight", (d,), "ones")]
        if i < cfg.first_dense:
            tensors += [(pre + "ffn_gate.weight", (cfg.n_ff, d), "w"), (pre + "ffn_up.weight", (cfg.n_ff, d), "w"),
                        (pre + "ffn_down.weight", (d, cfg.n_ff), "w")]
            continue
        e, n_sh = cfg.n_expert, n_shared * n_ff_exp
        tensors += [(pre + "ffn_gate_inp.weight", (e, d), 0.02), (pre + "exp_probs_b.bias", (e,), bias_std),
                    (pre + "ffn_gate_exps.weight", (e, n_ff_exp, d), "w"),
                    (pre + "ffn_up_exps.weight", (e, n_ff_exp, d), "w"),
                    (pre + "ffn_down_exps.weight", (e, d, n_ff_exp), "w"),
                    (pre + "ffn_gate_shexp.weight", (n_sh, d), "w"), (pre + "ffn_up_shexp.weight", (n_sh, d), "w"),
                    (pre + "ffn_down_shexp.weight", (d, n_sh), "w")]
    write_family_gguf(path, arch, keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
