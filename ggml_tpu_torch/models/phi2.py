"""The Phi-2 family (llama.cpp arch 'phi2') in PyTorch: GPT-J's parallel
residual with NeoX-style partial rotary (rotate-half on the first n_rot dims
of each head, the rest passed through), biased LayerNorms, biased q/k/v,
attn_output, MLP and head, and gelu_new written out.

Port of ggml_tpu/models/phi2.py: per layer h = LN(x), x = x + attn(h) +
mlp(h), f32 attention scores at scale 1/sqrt(head_dim), plain f32 PyTorch
over the whole cache window (models/common.gqa_attention).  The partial
RoPE here is also what glm4moe and gptneox import, as their JAX modules do.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     layer_norm as _layer_norm, linear as _linear, run_layers, window_keep)


@dataclass(frozen=True)
class Phi2Config:
    n_vocab: int = 51200
    n_ctx: int = 2048
    n_embd: int = 2560
    n_head: int = 32
    n_head_kv: int = 32
    n_layer: int = 32
    n_ff: int = 10240
    n_rot: int = 32  # partial_rotary_factor * head_dim (0.4 * 80)
    rope_base: float = 10000.0
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> Phi2Config:
    """The phi2.* metadata with the JAX reader's keys and defaults
    (phi2.py:53-68)."""
    md = g.metadata
    a = "phi2"
    n_head = int(md[f"{a}.attention.head_count"])
    n_embd = int(md[f"{a}.embedding_length"])
    return Phi2Config(
        n_vocab=int(md.get(f"{a}.vocab_size", 51200)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=n_embd,
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_rot=int(md.get(f"{a}.rope.dimension_count", n_embd // n_head)),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        eps=float(md.get(f"{a}.attention.layer_norm_epsilon", 1e-5)),
    )


@functools.cache
def _inv_freq(n_rot: int, base: float, device: torch.device) -> torch.Tensor:
    """base ** (-j / half) for j < half = n_rot / 2, in float64 numpy cast to
    float32, as phi2.py:75 computes it; copied to the device once (a
    captured decode graph reads the tensor)."""
    half = n_rot // 2
    return torch.from_numpy((base ** (-np.arange(half) / half)).astype(np.float32)).to(device)


def partial_angles(positions: torch.Tensor, n_rot: int, base: float):
    """cos, sin (b, t, 1, n_rot/2) f32 at positions (b, t): theta is the f32
    product of the positions and the frequencies.  Computed once per forward
    and shared by every layer's q and k."""
    theta = positions.float()[..., None] * _inv_freq(n_rot, base, positions.device)[None, None, :]
    return torch.cos(theta)[:, :, None, :], torch.sin(theta)[:, :, None, :]


def _rope_half_partial(x, cos, sin, n_rot: int):
    """rotate_half RoPE on the first n_rot dims of x (b, t, h, d), the rest
    passed through (ggml NeoX mode restricted to rope_dim; HF Phi's
    partial_rotary_factor).  cos, sin from partial_angles."""
    half = n_rot // 2
    rot, rest = x[..., :n_rot], x[..., n_rot:]
    x0, x1 = rot[..., :half], rot[..., half:]
    out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return torch.cat([out, rest.to(out.dtype)], dim=-1) if rest.shape[-1] else out


def _gelu_new(x):
    """gelu_new written out as phi2.py:144-145 writes it."""
    return 0.5 * x * (1.0 + torch.tanh(0.79788456080286535588 * x * (1.0 + 0.044715 * x * x)))


def init_cache(cfg: Phi2Config, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def forward(params: dict, cfg: Phi2Config, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (phi2.py:93-160); the arguments as models/gemma2.forward's."""
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

    def layer(i, x):
        pre = f"blk.{i}."
        h = _layer_norm(x, params[pre + "attn_norm.weight"], params[pre + "attn_norm.bias"], cfg.eps)
        q = _linear(h, params[pre + "attn_q.weight"], params[pre + "attn_q.bias"]).reshape(b, t, cfg.n_head, hd)
        k = _linear(h, params[pre + "attn_k.weight"], params[pre + "attn_k.bias"]).reshape(b, t, cfg.n_head_kv, hd)
        v = _linear(h, params[pre + "attn_v.weight"], params[pre + "attn_v.bias"]).reshape(b, t, cfg.n_head_kv, hd)
        q = _rope_half_partial(q, cos, sin, cfg.n_rot).transpose(1, 2)
        kc, vc = cache[i]
        cache_write(kc, _rope_half_partial(k, cos, sin, cfg.n_rot).transpose(1, 2), cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(q, kc, vc, keep, 1.0 / np.sqrt(hd))
        attn_out = _linear(out.to(dt), params[pre + "attn_output.weight"], params[pre + "attn_output.bias"])
        # parallel residual: the MLP reads the same normed input h
        ff = _gelu_new(_linear(h, params[pre + "ffn_up.weight"], params[pre + "ffn_up.bias"]))
        return x + attn_out + _linear(ff, params[pre + "ffn_down.weight"], params[pre + "ffn_down.bias"])

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
    return _linear(x, params["output.weight"], params.get("output.bias")), cache


class Phi2(FamilyModel):
    """Inference wrapper: prefill and on-device greedy or sampled decode
    (common.FamilyModel over phi2.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a phi2 GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`)."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def phi2_config() -> Phi2Config:
    """Phi-2 at its published widths (microsoft/phi-2 config.json: vocab
    51200, hidden 2560, 32 layers, 32 heads of 80, intermediate 10240,
    partial_rotary_factor 0.4 (n_rot 32), rope_theta 10000,
    layer_norm_eps 1e-5, 2048 positions; biased, untied head)."""
    return Phi2Config(n_vocab=51200, n_ctx=2048, n_embd=2560, n_head=32, n_head_kv=32, n_layer=32, n_ff=10240,
                      n_rot=32, rope_base=10000.0, eps=1e-5)


def write_random_gguf(path, cfg: Phi2Config, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write a phi2 file as llama.cpp's converter lays one out: the keys
    config_from_gguf reads, LayerNorms of ones with biases of std 0.02,
    biased q/k/v/attn_output/ffn_up/ffn_down and head (random_gguf.
    write_family_gguf: types, default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, f = cfg.n_embd, cfg.n_ff
    nkv = cfg.n_head_kv * cfg.head_dim
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("block_count", cfg.n_layer), ("feed_forward_length", f), ("rope.dimension_count", cfg.n_rot),
            ("rope.freq_base", float(cfg.rope_base)), ("attention.layer_norm_epsilon", float(cfg.eps))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output_norm.bias", (d,), 0.02), ("output.weight", (cfg.n_vocab, d), "w"),
               ("output.bias", (cfg.n_vocab,), 0.02)]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_norm.bias", (d,), 0.02),
                    (pre + "attn_q.weight", (d, d), "w"), (pre + "attn_q.bias", (d,), 0.02),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_k.bias", (nkv,), 0.02),
                    (pre + "attn_v.weight", (nkv, d), "w"), (pre + "attn_v.bias", (nkv,), 0.02),
                    (pre + "attn_output.weight", (d, d), "w"), (pre + "attn_output.bias", (d,), 0.02),
                    (pre + "ffn_up.weight", (f, d), "w"), (pre + "ffn_up.bias", (f,), 0.02),
                    (pre + "ffn_down.weight", (d, f), "w"), (pre + "ffn_down.bias", (d,), 0.02)]
    write_family_gguf(path, "phi2", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
