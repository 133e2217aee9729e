"""The Llama family (Llama-2/3 layout) in PyTorch: grouped-query attention,
RMSNorm, SwiGLU MLP, rotate-half (NeoX-mode) RoPE.

Port of ggml_tpu/models/llama.py (reference ops: RMS_NORM include/ggml.h:1127,
ROPE NeoX mode :1419, SILU :535, GQA through a broadcast mul_mat).  One
module serves the dense architectures of the registry's llama family:
llama, qwen2 and seed_oss (qkv biases, often a tied output), qwen3 (per-head
q/k RMSNorm, a decoupled head_dim), granite (embedding, residual, attention
and logit scales), smollm3 (NoPE layers), ernie4_5 and helium (interleaved
RoPE).  The mixture-of-experts block (n_expert > 0) is not ported.

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
  a head cannot be applied to packed planes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (cache_rows, cache_write, causal_mask, decode_loop, dequant_cache, init_layer_cache,
                     linear as _linear, make_sampled_decode, run_layers)
from .gptj import _random_weight_blocks, _rope_interleaved, rope_angles


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
    # mixture of experts (Mixtral, qwen2moe, qwen3moe, granitemoe): read from
    # the file, not ported (forward and Llama raise)
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


def _no_experts(cfg: LlamaConfig):
    if cfg.n_expert > 0:
        raise NotImplementedError("the llama family's mixture-of-experts block (n_expert > 0) is not ported yet "
                                  "(ROADMAP.md, section 1)")


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
    _no_experts(cfg)
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
    rep = cfg.n_head // n_kv
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
        visible = torch.arange(max_seq, device=dev)[None, None, None, None, :] <= positions[:, None, None, :, None]
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
        else:
            # grouped-query attention in f32 over the whole cache window (a q8
            # cache dequantized on read, llama.py:362-375): each kv head serves
            # the rep query heads beside it, whose rows are stacked so that
            # every product is one batched matmul
            with torch.profiler.record_function("llama.attention"):
                kd, vd = dequant_cache(kc), dequant_cache(vc)
                qg = q.reshape(b, n_kv, rep * t, hd).float()
                att = torch.matmul(qg, kd.float().transpose(-1, -2)) * scale
                att = att.view(b, n_kv, rep, t, max_seq)
                att = torch.where(visible, att, torch.full((), float("-inf"), device=dev))
                att = torch.softmax(att, dim=-1).to(vd.dtype)
                out = torch.matmul(att.view(b, n_kv, rep * t, max_seq), vd)
                out = out.view(b, cfg.n_head, t, hd).transpose(1, 2)
                attn_out = out.reshape(b, t, cfg.n_head * hd).to(dt)
        x = x + res(_linear(attn_out, params[pre + "attn_output.weight"]))

        h = _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps)
        gate = _linear(h, params[pre + "ffn_gate.weight"])
        up = _linear(h, params[pre + "ffn_up.weight"])
        return x + res(_linear(F.silu(gate) * up, params[pre + "ffn_down.weight"]))

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


class Llama:
    """Inference wrapper: prefill + on-device greedy or sampled decode."""

    def __init__(self, params: dict, cfg: LlamaConfig, max_seq: int = 2048, batch: int = 1, device="cuda"):
        _no_experts(cfg)
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.batch = batch
        self.device = torch.device(device)
        self.decode_graphs: dict = {}  # cache dtype -> common.DecodeGraph, made at the first graphed decode

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
            _no_experts(cfg)
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

    def _check_room(self, n_past: int, n_new: int):
        if n_past + n_new > self.max_seq:
            raise ValueError(f"{n_past} + {n_new} tokens exceed the cache of {self.max_seq}")

    def prefill(self, cache, tokens: np.ndarray):
        """Run the prompt (b, t) from an empty cache; returns (last-position
        logits (b, n_vocab), cache, t)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(self.device)
        t = tokens.shape[1]
        self._check_room(0, t)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        logits, cache = forward(self.params, self.cfg, tokens, zero.expand(tokens.shape[0]), cache, zero,
                                prefill=True)
        return logits[:, -1, :], cache, t

    def decode_logits(self, cache, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Logits (b, n_vocab) of tokens (b, 1) at position pos, a 0-d int32
        tensor on the model's device; their cache rows are written in place."""
        return forward(self.params, self.cfg, tokens, pos.expand(tokens.shape[0]), cache, pos)[0][:, -1, :]

    def decode_step(self, cache, token, n_past: int):
        """token (b, 1) at position n_past: returns (logits (b, n_vocab), cache)."""
        self._check_room(n_past, 1)
        token = torch.as_tensor(token).to(self.device, torch.long).reshape(-1, 1)
        return self.decode_logits(cache, token, torch.full((), n_past, dtype=torch.int32, device=self.device)), cache

    def decode_greedy(self, cache, first_token, n_past: int, n_tokens: int, graph=None):
        """Generate n_tokens greedily from first_token at position n_past, as
        one CUDA graph replay a token on the card (graph=False: eagerly; see
        common.decode_loop).  Returns (cache, ids (n_tokens, b) numpy)."""
        return decode_loop(self, cache, first_token, n_past, n_tokens, graph=graph)

    def decode_sampled(self, cache, first_token, n_past: int, n_tokens: int, key, **sampler_kw):
        """On-device top-k/top-p sampled decode, key a torch.Generator on the
        model's device (see common.make_sampled_decode)."""
        return make_sampled_decode(self)(cache, first_token, n_past, n_tokens, key, **sampler_kw)

    def generate(self, prompt_tokens: np.ndarray, n_tokens: int, sampler=None, key=None):
        from .common import generate

        return generate(self, prompt_tokens, n_tokens, sampler=sampler, key=key)


def llama3_8b_config() -> LlamaConfig:
    """Llama-3-8B at its published widths (meta-llama/Meta-Llama-3-8B
    config.json: vocab 128256, hidden 4096, 32 layers, 32 heads, 8 kv heads,
    intermediate 14336, rope_theta 500000, 8192 positions, rms_norm_eps
    1e-5; untied output)."""
    return LlamaConfig(n_vocab=128256, n_ctx=8192, n_embd=4096, n_head=32, n_head_kv=8, n_layer=32, n_ff=14336,
                       rope_base=500000.0, rms_eps=1e-5)


def write_random_gguf(path, cfg: LlamaConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None):
    """Write a llama GGUF file as llama.cpp's converter lays out a dense
    model (rotate-half q/k rows: load with llamacpp_permuted=False), its 2-D
    matmul weights blocks from quant/reference.random_blocks (weights of std
    about 0.02, as models/gptj.write_random_gguf draws them), its norms F32
    ones: a file for running the GGUF path at any width without a
    checkpoint.  types: a map from weight names ("token_embd.weight",
    "output.weight", "blk.{i}.attn_q.weight", ...) to types (Q4_K, Q6_K and
    the IQ* and TQ* types); Q4_K for a weight it does not name.
    tokenizer: GGUF tokenizer.ggml.* keys (without the prefix) -> values,
    written as they are."""
    from ..gguf import GGUFWriter

    arch = "llama"
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    w.add_string("general.architecture", arch)
    for key, val in (("context_length", cfg.n_ctx), ("embedding_length", cfg.n_embd),
                     ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
                     ("block_count", cfg.n_layer), ("feed_forward_length", cfg.n_ff), ("vocab_size", cfg.n_vocab)):
        w.add_u32(f"{arch}.{key}", val)
    w.add_f32(f"{arch}.rope.freq_base", cfg.rope_base)
    w.add_f32(f"{arch}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    for key, val in (tokenizer or {}).items():
        if isinstance(val, str):
            w.add_string(f"tokenizer.ggml.{key}", val)
        elif isinstance(val, int):
            w.add_u32(f"tokenizer.ggml.{key}", val)
        else:
            w.add_array(f"tokenizer.ggml.{key}", val)

    def weight(name, n, k):
        t = GGMLType((types or {}).get(name, GGMLType.Q4_K))
        w.add_tensor(name, _random_weight_blocks(t, n, k, rng), t, raw_shape_ne=(k, n))

    def ones(name, n):
        w.add_tensor(name, np.ones((n,), np.float32))

    E, hd = cfg.n_embd, cfg.head_dim
    weight("token_embd.weight", cfg.n_vocab, E)
    ones("output_norm.weight", E)
    weight("output.weight", cfg.n_vocab, E)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        ones(pre + "attn_norm.weight", E)
        weight(pre + "attn_q.weight", cfg.n_head * hd, E)
        weight(pre + "attn_k.weight", cfg.n_head_kv * hd, E)
        weight(pre + "attn_v.weight", cfg.n_head_kv * hd, E)
        weight(pre + "attn_output.weight", E, cfg.n_head * hd)
        ones(pre + "ffn_norm.weight", E)
        weight(pre + "ffn_gate.weight", cfg.n_ff, E)
        weight(pre + "ffn_up.weight", cfg.n_ff, E)
        weight(pre + "ffn_down.weight", E, cfg.n_ff)
    w.write(path)
