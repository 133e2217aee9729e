"""The Phi-3 family (llama.cpp arch 'phi3': Phi-3, Phi-3.5, Phi-4) in
PyTorch: a llama-shaped pre-norm GQA decoder with LongRoPE and an optional
uniform sliding window.

Port of ggml_tpu/models/phi3.py.  LongRoPE divides each frequency by a
per-dimension factor, the long set when the cache the forward is handed
holds more than n_ctx_orig rows and the short set otherwise (chosen
statically, as JAX chooses per compiled program and llama.cpp per context),
and scales cos and sin by attn_factor = sqrt(1 + ln(n_ctx / n_ctx_orig) /
ln(n_ctx_orig)).  The cos/sin are phimoe's (models/phimoe.rope_angles_phimoe,
the same computation).  A paged step hands the forward a window of P x
page_size rows and chooses by that width, as JAX's does.  Attention is
plain f32 PyTorch over the whole cache window (models/common.gqa_attention),
a q8 cache dequantized on read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     linear as _linear, run_layers, window_keep)
from .llama import _rms_norm, _rope_half
from .phimoe import rope_angles_phimoe


@dataclass(frozen=True)
class Phi3Config:
    n_vocab: int = 32064
    n_ctx: int = 4096
    n_ctx_orig: int = 4096  # original_max_position_embeddings
    n_embd: int = 3072
    n_head: int = 32
    n_head_kv: int = 32
    head_dim: int = 96
    n_layer: int = 32
    n_ff: int = 8192
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    sliding_window: int = 0  # 0: off; else the same window on every layer
    longrope: bool = False  # rope_factors_long/short tensors present
    attn_factor: float = 1.0  # cos/sin magnitude correction


def config_from_gguf(g: GGUFFile) -> Phi3Config:
    """The phi3.* metadata with the JAX reader's keys and defaults
    (phi3.py:59-86): LongRoPE where the file has rope_factors_long, its
    attn_factor from the file or from the two context lengths."""
    md = g.metadata
    a = "phi3"
    n_head = int(md[f"{a}.attention.head_count"])
    n_ctx = int(md[f"{a}.context_length"])
    n_ctx_orig = int(md.get(f"{a}.rope.scaling.original_context_length", n_ctx))
    longrope = "rope_factors_long.weight" in g.tensors
    attn_factor = float(md.get(f"{a}.rope.scaling.attn_factor", 0.0))
    if longrope and attn_factor == 0.0:
        attn_factor = (np.sqrt(1.0 + np.log(n_ctx / n_ctx_orig) / np.log(n_ctx_orig))
                       if n_ctx > n_ctx_orig else 1.0)
    return Phi3Config(
        n_vocab=int(md[f"{a}.vocab_size"]),
        n_ctx=n_ctx,
        n_ctx_orig=n_ctx_orig,
        n_embd=int(md[f"{a}.embedding_length"]),
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        head_dim=int(md.get(f"{a}.attention.key_length", int(md[f"{a}.embedding_length"]) // n_head)),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)),
        sliding_window=int(md.get(f"{a}.attention.sliding_window", 0)),
        longrope=longrope,
        attn_factor=float(attn_factor or 1.0),
    )


def init_cache(cfg: Phi3Config, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def rope_for(params: dict, cfg: Phi3Config, positions: torch.Tensor, window: int):
    """cos, sin (b, t, 1, head_dim/2) at positions for a cache of `window`
    rows: with LongRoPE the long factors above n_ctx_orig rows, the short
    ones at or below, and attn_factor on cos and sin (phi3.py:89-105)."""
    if not cfg.longrope:
        return rope_angles_phimoe(positions, cfg, None, 1.0)
    factors = params["rope_factors_long.weight" if window > cfg.n_ctx_orig else "rope_factors_short.weight"]
    return rope_angles_phimoe(positions, cfg, factors, cfg.attn_factor)


def mlp(params: dict, pre: str, h):
    """The SwiGLU MLP on a layer's normed input."""
    gate = _linear(h, params[pre + "ffn_gate.weight"])
    up = _linear(h, params[pre + "ffn_up.weight"])
    return _linear(F.silu(gate) * up, params[pre + "ffn_down.weight"])


def forward(params: dict, cfg: Phi3Config, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (phi3.py:115-173); the arguments as models/gemma2.forward's."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    dt = x.dtype
    hd = cfg.head_dim
    cos, sin = rope_for(params, cfg, positions, max_seq)
    rows = cache_rows(cache_len, t, max_seq)
    keep = window_keep(positions, max_seq, cfg.sliding_window)

    def layer(i, x):
        pre = f"blk.{i}."
        h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
        q = _linear(h, params[pre + "attn_q.weight"]).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"]).reshape(b, t, cfg.n_head_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"]).reshape(b, t, cfg.n_head_kv, hd)
        kc, vc = cache[i]
        cache_write(kc, _rope_half(k, cos, sin).transpose(1, 2), cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(_rope_half(q, cos, sin).transpose(1, 2), kc, vc, keep, hd ** -0.5)
        x = x + _linear(out.to(dt), params[pre + "attn_output.weight"])
        return x + mlp(params, pre, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps))

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
    return _linear(x, params.get("output.weight", params["token_embd.weight"])), cache


class Phi3(FamilyModel):
    """Inference wrapper: prefill and on-device greedy or sampled decode
    (common.FamilyModel over phi3.forward); the rope factors follow the
    length of the cache a forward is handed."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a phi3 GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`)."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def phi35_mini_config() -> Phi3Config:
    """Phi-3.5-mini at its published widths (microsoft/Phi-3.5-mini-instruct
    config.json: vocab 32064, hidden 3072, 32 layers, 32 heads (32 kv) of
    96, intermediate 8192, rope_theta 10000, LongRoPE from
    original_max_position_embeddings 4096 to 131072, rms_norm_eps 1e-5,
    sliding_window 262144, which no context reaches: 0 here; untied head).
    attn_factor is what config_from_gguf derives from the two lengths."""
    return Phi3Config(n_vocab=32064, n_ctx=131072, n_ctx_orig=4096, n_embd=3072, n_head=32, n_head_kv=32,
                      head_dim=96, n_layer=32, n_ff=8192, rope_base=10000.0, rms_eps=1e-5, longrope=True,
                      attn_factor=float(np.sqrt(1.0 + np.log(131072 / 4096) / np.log(4096))))


def write_random_gguf(path, cfg: Phi3Config, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write a phi3 file as llama.cpp's converter lays one out (fused qkv and
    gate_up split into attn_q/k/v and ffn_gate/ffn_up): the keys
    config_from_gguf reads, RMSNorms of ones, an untied head and, where
    cfg.longrope, rope_factors_long and rope_factors_short (head_dim / 2
    values each, drawn from the seed: short ones in [1, 1.5), long ones
    rising from 1 to about 40, the shapes of the published arrays); a
    sliding window where cfg has one (random_gguf.write_family_gguf: types,
    default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, f, hd = cfg.n_embd, cfg.n_ff, cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("attention.key_length", hd), ("attention.value_length", hd), ("block_count", cfg.n_layer),
            ("feed_forward_length", f), ("rope.freq_base", float(cfg.rope_base)),
            ("rope.dimension_count", hd), ("rope.scaling.original_context_length", cfg.n_ctx_orig),
            ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps))]
    if cfg.sliding_window:
        keys.append(("attention.sliding_window", cfg.sliding_window))
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_q.weight", (nq, d), "w"),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_v.weight", (nkv, d), "w"),
                    (pre + "attn_output.weight", (d, nq), "w"), (pre + "ffn_norm.weight", (d,), "ones"),
                    (pre + "ffn_gate.weight", (f, d), "w"), (pre + "ffn_up.weight", (f, d), "w"),
                    (pre + "ffn_down.weight", (d, f), "w")]
    extra = {}
    if cfg.longrope:
        rng = np.random.default_rng(seed + 1)
        extra = {"rope_factors_short.weight": np.sort(1.0 + 0.5 * rng.random(hd // 2)).astype(np.float32),
                 "rope_factors_long.weight": np.sort(1.0 + 39.0 * rng.random(hd // 2) ** 2).astype(np.float32)}
    write_family_gguf(path, "phi3", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type, arrays=extra)
