"""The Llama family (Llama-2/3 layout) in PyTorch: grouped-query attention,
RMSNorm, SwiGLU MLP, rotate-half (NeoX-mode) RoPE.

Port of ggml_tpu/models/llama.py (reference ops: RMS_NORM include/ggml.h:1127,
ROPE NeoX mode :1419, SILU :535, GQA through a broadcast mul_mat).  One
module serves the dense architectures of the registry's llama family:
llama, qwen2 and seed_oss (qkv biases, often a tied output), qwen3 (per-head
q/k RMSNorm, a decoupled head_dim), granite (embedding, residual, attention
and logit scales), smollm3 (NoPE layers), ernie4_5 and helium (interleaved
RoPE), and their mixture-of-experts variants (Mixtral under llama,
qwen2moe with its shared expert, qwen3moe, granitemoe: moe_ffn_block).

- quantized weights stay planes in device memory and run through the
  hand-written kernels of ggml_tpu_torch.kernels.qmatmul (a Q4_K file at
  Llama-3-8B's widths: A at K = 4096, H over expanded planes at ffn_down's
  K = 14336, F or G on a Q6_K head, C at prefill);
- prefill from an empty cache takes kernel J's flash attention at
  flash_min_seq tokens or more (or with use_flash_prefill), its mask tile
  ranges computed once per forward; every other step attends over the
  whole cache window in plain f32 PyTorch, as the JAX forward does
  (llama.py:362-375), with the positions read on the device, so a decode
  step runs in a CUDA graph (models/common.DecodeGraph);
- RoPE: rotate-half over each head's dims (the HF transformers layout).
  GGUF files converted by llama.cpp store q/k rows with an extra per-head
  permutation; `Llama.from_gguf(..., llamacpp_permuted=True)` undoes it at
  load, dequantizing q and k to dense weights (a permutation of rows inside
  a head cannot be applied to packed planes);
- the experts (3-D *_exps tensors, dequantized at load as in JAX) run as
  plain PyTorch products, as JAX runs them outside any Pallas kernel: below
  16 tokens a gate-masked sum over every expert (moe_expert_sum, decode),
  from 16 tokens the (token, expert) pairs sorted by expert through
  torch._grouped_mm with the group offsets on the device (moe_expert_sum_
  grouped, prefill and training), so neither reads a value on the host and
  both run inside a CUDA graph.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, causal_mask, gqa_attention, init_layer_cache,
                     linear as _linear, run_layers, window_keep)
from .gptj import _rope_interleaved, rope_angles


@dataclass(frozen=True)
class LlamaConfig:
    n_vocab: int = 32000
    n_ctx: int = 4096
    n_embd: int = 4096
    n_head: int = 32
    n_head_kv: int = 32
    n_layer: int = 32
    n_ff: int = 11008
    rope_base: float = 10000.0
    # context-extension rope scaling (ggml_rope_ext's YaRN parameters; GGUF
    # llama.rope.scaling.* keys)
    rope_scaling: str = "none"  # none | linear | yarn
    rope_scale: float = 1.0  # scaling factor (freq_scale = 1/factor)
    n_ctx_orig: int = 0  # original context length (YaRN ramp)
    rms_eps: float = 1e-5
    # qwen3: per-head RMSNorm on q/k before rope, head_dim decoupled from
    # n_embd // n_head
    qk_norm: bool = False
    head_dim_override: int = 0
    # mixture of experts (Mixtral, qwen2moe, qwen3moe, granitemoe): the
    # experts' count and how many a token uses; qwen2moe keeps the top-k
    # probabilities of the softmax over all experts (moe_renorm False) and
    # adds a sigmoid-gated shared expert
    n_expert: int = 0
    n_expert_used: int = 0
    moe_renorm: bool = True
    moe_shared: bool = False
    # granite: fixed scalar multipliers (GGUF granite.embedding_scale,
    # residual_scale, attention.scale, logit_scale)
    embd_scale: float = 1.0
    resid_scale: float = 1.0
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    logit_scale: float = 1.0  # the logits are divided by it
    # smollm3: every nope_interval-th layer (1-indexed) attends without RoPE
    nope_interval: int = 0
    # ernie4_5, helium: interleaved-pair RoPE over the whole head (ggml rope
    # mode 0) in place of rotate-half
    rope_interleaved: bool = False
    # prompts of flash_min_seq tokens or more (or any prompt with
    # use_flash_prefill) prefill through the flash kernel
    use_flash_prefill: bool = False
    flash_min_seq: int = 1024

    @property
    def head_dim(self):
        return self.head_dim_override or self.n_embd // self.n_head


# the architecture strings whose keys config_from_gguf reads (any other reads llama.*)
_ARCHS = ("llama", "qwen2", "qwen3", "qwen2moe", "qwen3moe", "granite", "granitemoe", "smollm3", "ernie4_5",
          "helium", "seed_oss")


def config_from_gguf(g: GGUFFile) -> LlamaConfig:
    """The llama-family metadata of a GGUF file under its architecture's key
    prefix (llama.py:86-122)."""
    md = g.metadata
    a = md.get("general.architecture", "llama")
    if a not in _ARCHS:
        a = "llama"
    return LlamaConfig(
        nope_interval=int(md.get(f"{a}.no_rope_layer_interval", 0)),
        rope_interleaved=(a in ("ernie4_5", "helium")),
        qk_norm=a in ("qwen3", "qwen3moe"),
        embd_scale=float(md.get(f"{a}.embedding_scale", 1.0)),
        resid_scale=float(md.get(f"{a}.residual_scale", 1.0)),
        attn_scale=float(md.get(f"{a}.attention.scale", 0.0)),
        logit_scale=float(md.get(f"{a}.logit_scale", 1.0)),
        moe_renorm=(a != "qwen2moe"),
        moe_shared=(a == "qwen2moe"),
        head_dim_override=int(md.get(f"{a}.attention.key_length", 0)),
        n_vocab=int(md.get(f"{a}.vocab_size", 32000)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=int(md[f"{a}.attention.head_count"]),
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", md[f"{a}.attention.head_count"])),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rope_scaling=str(md.get(f"{a}.rope.scaling.type", "none")),
        rope_scale=float(md.get(f"{a}.rope.scaling.factor", 1.0)),
        n_ctx_orig=int(md.get(f"{a}.rope.scaling.original_context_length", 0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
        n_expert=int(md.get(f"{a}.expert_count", 0)),
        n_expert_used=int(md.get(f"{a}.expert_used_count", 0)),
    )


def _rms_norm(x, w, eps):
    """Normalized in f32, cast back to x's type, then times w (llama.py:125-128)."""
    v = torch.mean(x.float() ** 2, dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(v + eps)).to(x.dtype) * w


def _rope_half_angles(positions, cfg: LlamaConfig):
    """cos, sin (b, t, 1, head_dim/2) f32 of the rotate-half RoPE at positions
    (b, t), with the config's context-extension scaling (llama.py:133-174):
    none (the float64 host frequencies of rope_angles), linear position
    interpolation, or YaRN's per-dim ramp and magnitude correction
    (ops.core.rope_cos_sin, the ggml_rope_ext semantics).  Computed once per
    forward and shared by every layer's q and k."""
    d = cfg.head_dim
    if cfg.rope_scaling in ("none", "") or (cfg.rope_scaling == "linear" and cfg.rope_scale == 1.0):
        return rope_angles(positions, d, cfg.rope_base)
    from ..ops.core import rope_cos_sin, rope_yarn_corr_dims

    b, t = positions.shape
    freq_scale = 1.0 / cfg.rope_scale if cfg.rope_scale else 1.0
    if cfg.rope_scaling == "yarn":
        corr = rope_yarn_corr_dims(d, cfg.n_ctx_orig or cfg.n_ctx, cfg.rope_base, 32.0, 1.0)
        ext_factor = 1.0
    else:  # linear
        corr, ext_factor = (0.0, d - 1.0), 0.0
    cos, sin = rope_cos_sin(positions.reshape(-1), d, cfg.rope_base, freq_scale, ext_factor, 1.0, corr)
    return cos.reshape(b, t, 1, d // 2), sin.reshape(b, t, 1, d // 2)


def _rope_half(x, cos, sin):
    """rotate_half RoPE over the whole head dim (ggml NeoX mode, HF llama).
    x: (b, t, h, d); cos, sin from _rope_half_angles."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)


def permute_llamacpp_qk(w, n_head: int):
    """llama.cpp's converter permutation of q/k rows: each head's rows
    regrouped so that an interleaved RoPE sees the rotate-half layout.
    (N, K) -> (H, 2, N/H/2, K) -> swap -> (N, K)."""
    n, k = w.shape
    return w.reshape(n_head, 2, n // n_head // 2, k).transpose(1, 2).reshape(n, k)


def unpermute_llamacpp_qk(w, n_head: int):
    """Inverse of permute_llamacpp_qk."""
    n, k = w.shape
    return w.reshape(n_head, n // n_head // 2, 2, k).transpose(1, 2).reshape(n, k)


def init_cache(cfg: LlamaConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last axis of an f32 tensor: (values, indices),
    each (..., k), by the floats' total order (-0.0 below 0.0), the lower
    index first among equal values (torch.topk promises no order, and bf16
    router logits over 128 experts tie often): a stable descending sort of
    the int32 keys that order the f32 bit patterns as that total order
    does."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # a negative float's magnitude bits flipped
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return x.gather(-1, idx), idx


def moe_topk(router_logits: torch.Tensor, n_expert_used: int, renorm: bool = True):
    """Top-k routing weights over f32 router logits (llama.py:230-240):
    renorm (Mixtral, qwen3moe, granitemoe) a softmax over the k values,
    otherwise (qwen2moe) exp(top - logsumexp(all)), the full softmax's
    probabilities of the k experts, which do not sum to 1.  Returns (probs,
    idx), each (..., k), the experts in jax.lax.top_k's order (top_k)."""
    logits = router_logits.float()
    vals, idx = top_k(logits, n_expert_used)
    if renorm:
        return torch.softmax(vals, dim=-1), idx
    return torch.exp(vals - torch.logsumexp(logits, dim=-1, keepdim=True)), idx


def moe_gates(router_logits: torch.Tensor, n_expert: int, n_expert_used: int, renorm: bool = True):
    """The (..., E) f32 gate vector: the top-k weights at their experts,
    zeros elsewhere (llama.py:243-248)."""
    probs, idx = moe_topk(router_logits, n_expert_used, renorm)
    return torch.zeros((*probs.shape[:-1], n_expert), dtype=torch.float32, device=probs.device).scatter(
        -1, idx, probs)


def moe_expert_sum(h, w_gate, w_up, w_down, gates):
    """The gate-weighted sum of every expert's SwiGLU FFN (llama.py:251-259):
    w_gate, w_up (E, F, D), w_down (E, D, F), gates (..., E).  Each product
    reads every expert, as decode must stream them all under JAX's dense
    path; dense f32 products run in full f32 (TF32 off, Precision.HIGHEST).
    The result comes back in h's type."""
    lead, d = h.shape[:-1], h.shape[-1]
    e, f = w_gate.shape[0], w_gate.shape[1]
    x = h.reshape(-1, d).to(w_gate.dtype)
    hg = torch.matmul(x, w_gate.reshape(e * f, d).t()).view(-1, e, f)
    hu = torch.matmul(x.to(w_up.dtype), w_up.reshape(e * f, d).t()).view(-1, e, f)
    act = F.silu(hg) * hu
    y = torch.matmul(act.transpose(0, 1), w_down.to(act.dtype).transpose(1, 2))  # (E, n, D)
    out = torch.einsum("end,ne->nd", y, gates.reshape(-1, e).to(y.dtype))
    return out.reshape(*lead, d).to(h.dtype)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient:
    torch._grouped_mm's own backward refuses an expanded one (the gradient
    of y.sum() raised "Invalid strides/sizes, got [0, 0]" on the CPU and on
    the card)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of x (M, K) sorted by group against a stack of weights w (G, N,
    K): rows [offs[g-1], offs[g]) times w[g]^T, through torch._grouped_mm
    with the int32 group ends offs (G,) on x's device (JAX's
    ragged_dot_general).  Differentiable in x and w.  On the card only bf16
    runs: there _grouped_mm takes other types through a fallback that
    copies the offsets to the host, which no CUDA graph can hold and which
    reads the group sizes the device computed, so the port raises."""
    if x.is_cuda and (x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16):
        raise NotImplementedError(
            f"the grouped expert product on the card takes bfloat16 experts; torch._grouped_mm computes "
            f"{x.dtype} x {w.dtype} there through a fallback that reads the group offsets on the host "
            "(load the model in bfloat16, or set GGML_TPU_MOE_GROUPED=0 for the dense path)")
    return _ContiguousGrad.apply(torch._grouped_mm(x, w.transpose(-2, -1), offs=offs))


def sort_by_expert(top_idx: torch.Tensor, n_expert: int):
    """The (token, expert) pairs of top_idx (..., k) sorted by expert
    (stable): (order, the token of each sorted pair, the int32 group ends
    (E,)).  The group ends come from a search of the sorted experts on the
    device (no bincount: on the card it reads its maximum on the host)."""
    k = top_idx.shape[-1]
    flat_e = top_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    offs = torch.searchsorted(flat_e[order], torch.arange(n_expert, device=flat_e.device), right=True)
    return order, order // k, offs.to(torch.int32)  # pair j is token j // k's


def add_back(rows: torch.Tensor, order: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The weighted rows (n k, D) of the sorted pairs added back to their n
    tokens, each token's k rows in the order JAX's scatter-add applies them,
    by expert, in the rows' type; every index op here has a deterministic
    backward."""
    dev = rows.device
    where = torch.empty_like(order)
    where[order] = torch.arange(n * k, device=dev)  # the sorted row of each pair
    where = where.view(n, k).sort(dim=1).values  # a token's rows in sorted (expert) order
    out = torch.zeros((n, rows.shape[-1]), dtype=rows.dtype, device=dev)
    for j in range(k):
        out = out + rows[where[:, j]]
    return out


def moe_expert_sum_grouped(h, w_gate, w_up, w_down, top_probs, top_idx, n_expert: int):
    """moe_expert_sum over only the chosen experts (llama.py:262-292): the
    (token, expert) pairs sorted by expert (sort_by_expert), three grouped
    products over the sorted rows, the rows weighted by their gates and
    added back to their tokens (add_back).  Differentiable (finetuning runs
    through it)."""
    b, t, d = h.shape
    k = top_idx.shape[-1]
    n = b * t
    order, tok, offs = sort_by_expert(top_idx, n_expert)
    xs = h.reshape(n, d)[tok].to(w_gate.dtype)  # (n k, D) sorted by expert
    hg = grouped_matmul(xs, w_gate, offs)  # (n k, F)
    hu = grouped_matmul(xs, w_up.to(xs.dtype), offs)
    down = grouped_matmul(F.silu(hg) * hu, w_down.to(hg.dtype), offs)  # (n k, D)
    rows = down * top_probs.reshape(n * k)[order][:, None].to(down.dtype)
    return add_back(rows, order, n, k).reshape(b, t, d).to(h.dtype)


def moe_ffn_block(params: dict, pre: str, h, cfg: LlamaConfig):
    """The sparse mixture-of-experts FFN of a llama-family layer (llama.py:
    191-227), shared by the dense forward and the paged step: the router
    (ffn_gate_inp, (E, D)), then below 16 tokens the dense gate-masked sum
    over all experts and from 16 the grouped sum over the chosen ones, as
    JAX's GGML_TPU_MOE_GROUPED reads (auto; 1 always grouped, 0 never), then
    qwen2moe's sigmoid-gated shared expert."""
    w_gate = params[pre + "ffn_gate_exps.weight"]
    w_up = params[pre + "ffn_up_exps.weight"]
    w_down = params[pre + "ffn_down_exps.weight"]
    with torch.profiler.record_function("llama.moe_router"):
        router = _linear(h, params[pre + "ffn_gate_inp.weight"])
    n_tokens = h.shape[0] * h.shape[1]
    mode = os.environ.get("GGML_TPU_MOE_GROUPED", "auto")
    with torch.profiler.record_function("llama.moe_experts"):
        if mode == "1" or (mode == "auto" and n_tokens >= 16):
            probs, idx = moe_topk(router, cfg.n_expert_used, cfg.moe_renorm)
            out = moe_expert_sum_grouped(h, w_gate, w_up, w_down, probs, idx, cfg.n_expert)
        else:
            gates = moe_gates(router, cfg.n_expert, cfg.n_expert_used, cfg.moe_renorm)
            out = moe_expert_sum(h, w_gate, w_up, w_down, gates)
    if cfg.moe_shared:  # qwen2moe: a dense SwiGLU expert every token takes, gated by a sigmoid
        sg = torch.sigmoid(_linear(h, params[pre + "ffn_gate_inp_shexp.weight"]))
        gate = _linear(h, params[pre + "ffn_gate_shexp.weight"])
        up = _linear(h, params[pre + "ffn_up_shexp.weight"])
        out = out + sg * _linear(F.silu(gate) * up, params[pre + "ffn_down_shexp.weight"])
    return out


def ffn_block(params: dict, pre: str, h, cfg: LlamaConfig):
    """A layer's FFN on its normed input: the experts where the model has
    them, else the SwiGLU MLP (llama.py:378-384)."""
    if cfg.n_expert > 0:
        return moe_ffn_block(params, pre, h, cfg)
    gate = _linear(h, params[pre + "ffn_gate.weight"])
    up = _linear(h, params[pre + "ffn_up.weight"])
    return _linear(F.silu(gate) * up, params[pre + "ffn_down.weight"])


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache); the cache is written
    in place and returned (llama.py:304-393).

    pos_start (b,) and cache_len are integer tensors on the model's device;
    cache_len is 0-d (the whole batch at one position) or (b,) (a position
    per row: the serving engine's step, each row written at its own position
    and masked by kv_pos <= q_pos).  prefill=True asserts that the cache is
    empty below pos_start: only then may the flash path attend just the
    current tokens.  A multi-token step against a populated cache leaves it
    False and attends over the cache window.  need_logits=False skips the
    final norm and the head and returns (None, cache): a prefill that only
    fills the cache (serve.Engine's admission).  layer_remat: each layer
    rematerialized (common.run_layers)."""
    b, t = tokens.shape
    dev = tokens.device
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=dev)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    if cfg.embd_scale != 1.0:  # granite embedding multiplier
        x = x * cfg.embd_scale
    dt = x.dtype
    hd, n_kv = cfg.head_dim, cfg.n_head_kv
    scale = cfg.attn_scale or 1.0 / np.sqrt(hd)
    res = (lambda y: y) if cfg.resid_scale == 1.0 else (lambda y: cfg.resid_scale * y)
    cos, sin = rope_angles(positions, hd, cfg.rope_base) if cfg.rope_interleaved else _rope_half_angles(positions, cfg)
    rows = cache_rows(cache_len, t, max_seq)  # cache rows written
    flash = t > 1 and prefill and (cfg.use_flash_prefill or t >= cfg.flash_min_seq)
    if flash:
        # prefill from an empty cache attends the current tokens only, through
        # the flash kernel; every layer reads the same mask, so its tile
        # ranges are computed once
        from ..kernels.flash_attn import flash_attention, mask_ranges

        mask = causal_mask(t, dev)
        ranges = mask_ranges(mask)
    else:  # which cache rows each query row sees, the same for every layer
        visible = window_keep(positions, max_seq)
    def layer(i, x):
        pre = f"blk.{i}."
        h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
        # qkv biases where the file has them (qwen2, seed_oss)
        q = _linear(h, params[pre + "attn_q.weight"], params.get(pre + "attn_q.bias")).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"], params.get(pre + "attn_k.bias")).reshape(b, t, n_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"], params.get(pre + "attn_v.bias")).reshape(b, t, n_kv, hd)
        if cfg.qk_norm:  # qwen3: per-head RMSNorm over head_dim, before RoPE
            q = _rms_norm(q, params[pre + "attn_q_norm.weight"], cfg.rms_eps)
            k = _rms_norm(k, params[pre + "attn_k_norm.weight"], cfg.rms_eps)
        if not (cfg.nope_interval and (i + 1) % cfg.nope_interval == 0):
            if cfg.rope_interleaved:
                q, k = _rope_interleaved(q, cos, sin, hd), _rope_interleaved(k, cos, sin, hd)
            else:
                q, k = _rope_half(q, cos, sin), _rope_half(k, cos, sin)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v, cache_len, rows)
        if flash:
            # in a bf16 model RoPE leaves q and k in f32 beside a bf16 v; they
            # go in as they are, and the output comes back in q's type
            out = flash_attention(q, k, v, mask=mask, scale=scale, ranges=ranges)
            attn_out = out.reshape(b, t, cfg.n_head * hd).to(dt)
        else:  # grouped-query attention in f32 over the whole cache window (llama.py:362-375)
            attn_out = gqa_attention(q, kc, vc, visible, scale).to(dt)
        x = x + res(_linear(attn_out, params[pre + "attn_output.weight"]))

        return x + res(ffn_block(params, pre, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps), cfg))

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
    # a tied output multiplies by the token embedding (its dense copy, where
    # the embedding is planes)
    w_out = params.get("output.weight", params.get("token_embd.weight@dense", params["token_embd.weight"]))
    logits = _linear(x, w_out)
    if cfg.logit_scale != 1.0:  # granite's logit divisor
        logits = logits / cfg.logit_scale
    return logits, cache


class Llama(FamilyModel):
    """Inference wrapper: prefill + on-device greedy or sampled decode
    (common.FamilyModel over llama.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, llamacpp_permuted: bool = False,
                  device="cuda", **kw):
        """Load a llama-family GGUF file (or the first shard of a split one)
        onto `device`: its quantized matmul weights stay planes, or, with
        keep_quantized=False, every tensor is dequantized to `dtype`.
        llamacpp_permuted: undo llama.cpp's q/k row permutation, on dense
        q and k weights."""
        from ..quant.planar import PlanarWeight
        from .gpt2 import load_params  # the GGUF tensor-naming loader

        with GGUFFile(path) as g:
            cfg = config_from_gguf(g)
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            if llamacpp_permuted:
                for i in range(cfg.n_layer):
                    for nm, nh in ((f"blk.{i}.attn_q.weight", cfg.n_head), (f"blk.{i}.attn_k.weight", cfg.n_head_kv)):
                        w = params[nm]
                        if isinstance(w, PlanarWeight):  # rows inside a head move: reload dense
                            w = torch.from_numpy(g.to_float32(nm)).to(device, dtype)
                        params[nm] = unpermute_llamacpp_qk(w, nh)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def llama3_8b_config() -> LlamaConfig:
    """Llama-3-8B at its published widths (meta-llama/Meta-Llama-3-8B
    config.json: vocab 128256, hidden 4096, 32 layers, 32 heads, 8 kv heads,
    intermediate 14336, rope_theta 500000, 8192 positions, rms_norm_eps
    1e-5; untied output)."""
    return LlamaConfig(n_vocab=128256, n_ctx=8192, n_embd=4096, n_head=32, n_head_kv=8, n_layer=32, n_ff=14336,
                       rope_base=500000.0, rms_eps=1e-5)


def qwen3_30b_a3b_config() -> LlamaConfig:
    """Qwen3-30B-A3B at its published widths (Qwen/Qwen3-30B-A3B
    config.json: vocab 151936, hidden 2048, 48 layers, 32 heads over 4 kv
    heads, head_dim 128, 128 experts with 8 a token, moe_intermediate_size
    768, intermediate_size 6144, rope_theta 1e6, rms_norm_eps 1e-6,
    norm_topk_prob true, 40960 positions; untied output).  n_ff is the
    file's feed_forward_length (6144); the experts' width (768) is their
    tensors' (write_random_gguf's n_ff_exp)."""
    return LlamaConfig(n_vocab=151936, n_ctx=40960, n_embd=2048, n_head=32, n_head_kv=4, n_layer=48, n_ff=6144,
                       rope_base=1e6, rms_eps=1e-6, qk_norm=True, head_dim_override=128, n_expert=128,
                       n_expert_used=8)


def write_random_gguf(path, cfg: LlamaConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, arch: str = "llama", n_ff_exp: int | None = None,
                      default_type: GGMLType = GGMLType.Q4_K):
    """Write a llama-family GGUF file as llama.cpp's converter lays out a
    model (rotate-half q/k rows: load with llamacpp_permuted=False), its
    matmul weights blocks from quant/reference.random_blocks (weights of std
    about 0.02, as models/gptj.write_random_gguf draws them), its norms F32
    ones: a file for running the GGUF path at any width without a
    checkpoint.  types: a map from weight names ("token_embd.weight",
    "output.weight", "blk.{i}.attn_q.weight", "blk.{i}.ffn_down_exps.weight",
    ...) to types (Q4_K, Q6_K, the IQ* and TQ* types, or F32 for normal
    values of std 0.02); default_type for a weight it does not name.
    arch: the key prefix and general.architecture; qwen2 and qwen2moe files
    get F32 q/k/v biases, qwen3 and qwen3moe per-head q/k norms (ones) and
    attention.key_length, granite and granitemoe their four scales.
    A config with experts (cfg.n_expert > 0) gets expert_count,
    expert_used_count and expert_feed_forward_length, and in every layer an
    F32 router ffn_gate_inp (E, D), as llama.cpp's quantizer leaves it, and
    the stacked 3-D expert tensors ffn_gate_exps, ffn_up_exps (E, n_ff_exp,
    D) and ffn_down_exps (E, D, n_ff_exp) in place of the MLP (n_ff_exp:
    cfg.n_ff by default; JAX reads the width from these shapes); qwen2moe
    also the shared expert ffn_{gate,up,down}_shexp (width cfg.n_ff) and its
    F32 gate ffn_gate_inp_shexp (1, D).
    tokenizer: GGUF tokenizer.ggml.* keys (without the prefix) -> values,
    written as they are (random_gguf.write_family_gguf draws and writes)."""
    from .random_gguf import write_family_gguf

    n_ff_exp = n_ff_exp or cfg.n_ff
    keys = [("context_length", cfg.n_ctx), ("embedding_length", cfg.n_embd), ("attention.head_count", cfg.n_head),
            ("attention.head_count_kv", cfg.n_head_kv), ("block_count", cfg.n_layer),
            ("feed_forward_length", cfg.n_ff), ("vocab_size", cfg.n_vocab)]
    if cfg.head_dim_override:
        keys += [("attention.key_length", cfg.head_dim), ("attention.value_length", cfg.head_dim)]
    if cfg.n_expert:
        keys += [("expert_count", cfg.n_expert), ("expert_used_count", cfg.n_expert_used),
                 ("expert_feed_forward_length", n_ff_exp)]
        if arch == "qwen2moe":
            keys.append(("expert_shared_feed_forward_length", cfg.n_ff))
    keys += [("rope.freq_base", float(cfg.rope_base)), ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps))]
    if arch in ("granite", "granitemoe"):
        keys += [("embedding_scale", float(cfg.embd_scale)), ("residual_scale", float(cfg.resid_scale)),
                 ("attention.scale", float(cfg.attn_scale)), ("logit_scale", float(cfg.logit_scale))]
    E, hd = cfg.n_embd, cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    tensors = [("token_embd.weight", (cfg.n_vocab, E), "w"), ("output_norm.weight", (E,), "ones"),
               ("output.weight", (cfg.n_vocab, E), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (E,), "ones"), (pre + "attn_q.weight", (nq, E), "w"),
                    (pre + "attn_k.weight", (nkv, E), "w"), (pre + "attn_v.weight", (nkv, E), "w")]
        if arch in ("qwen2", "qwen2moe"):
            tensors += [(pre + "attn_q.bias", (nq,), 0.02), (pre + "attn_k.bias", (nkv,), 0.02),
                        (pre + "attn_v.bias", (nkv,), 0.02)]
        if arch in ("qwen3", "qwen3moe"):
            tensors += [(pre + "attn_q_norm.weight", (hd,), "ones"), (pre + "attn_k_norm.weight", (hd,), "ones")]
        tensors += [(pre + "attn_output.weight", (E, nq), "w"), (pre + "ffn_norm.weight", (E,), "ones")]
        if cfg.n_expert:
            tensors += [(pre + "ffn_gate_inp.weight", (cfg.n_expert, E), 0.02),
                        (pre + "ffn_gate_exps.weight", (cfg.n_expert, n_ff_exp, E), "w"),
                        (pre + "ffn_up_exps.weight", (cfg.n_expert, n_ff_exp, E), "w"),
                        (pre + "ffn_down_exps.weight", (cfg.n_expert, E, n_ff_exp), "w")]
            if arch == "qwen2moe":
                tensors += [(pre + "ffn_gate_inp_shexp.weight", (1, E), 0.02),
                            (pre + "ffn_gate_shexp.weight", (cfg.n_ff, E), "w"),
                            (pre + "ffn_up_shexp.weight", (cfg.n_ff, E), "w"),
                            (pre + "ffn_down_shexp.weight", (E, cfg.n_ff), "w")]
        else:
            tensors += [(pre + "ffn_gate.weight", (cfg.n_ff, E), "w"), (pre + "ffn_up.weight", (cfg.n_ff, E), "w"),
                        (pre + "ffn_down.weight", (E, cfg.n_ff), "w")]
    write_family_gguf(path, arch, keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
