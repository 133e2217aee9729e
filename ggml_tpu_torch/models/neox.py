"""The GPT-NeoX family (llama.cpp arch 'gptneox': Pythia, GPT-NeoX-20B) in
PyTorch: two LayerNorms over the same pre-block x, attention reading the
first and the MLP the second, added in parallel (or in sequence with
parallel_residual=False), partial NeoX RoPE, biased projections, erf GELU,
an untied head.

Port of ggml_tpu/models/neox.py.  The partial RoPE is models/phi2's, as the
JAX module imports phi2's; attention is plain f32 PyTorch over the whole
cache window (models/common.gqa_attention, one kv head a query head).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (FamilyModel, cache_rows, cache_write, gqa_attention, init_layer_cache,
                     layer_norm as _layer_norm, linear as _linear, run_layers, window_keep)
from .phi2 import _rope_half_partial, partial_angles


@dataclass(frozen=True)
class NeoXConfig:
    n_vocab: int = 50304
    n_ctx: int = 2048
    n_embd: int = 2048
    n_head: int = 16
    n_layer: int = 24
    n_ff: int = 8192
    n_rot: int = 32  # rotary_pct * head_dim
    rope_base: float = 10000.0
    eps: float = 1e-5
    parallel_residual: bool = True

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> NeoXConfig:
    """The gptneox.* metadata with the JAX reader's keys and defaults
    (neox.py:51-67)."""
    md = g.metadata
    a = "gptneox"
    n_embd = int(md[f"{a}.embedding_length"])
    n_head = int(md[f"{a}.attention.head_count"])
    return NeoXConfig(
        n_vocab=int(md.get(f"{a}.vocab_size", 50304)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=n_embd,
        n_head=n_head,
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        n_rot=int(md.get(f"{a}.rope.dimension_count", n_embd // n_head)),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        eps=float(md.get(f"{a}.attention.layer_norm_epsilon", 1e-5)),
        parallel_residual=bool(md.get(f"{a}.use_parallel_residual", True)),
    )


def init_cache(cfg: NeoXConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head, max_seq, cfg.head_dim, dtype, device)


def forward(params: dict, cfg: NeoXConfig, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache), the cache written in
    place (neox.py:78-142); the arguments as models/gemma2.forward's."""
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
        k = _linear(h, params[pre + "attn_k.weight"], params[pre + "attn_k.bias"]).reshape(b, t, cfg.n_head, hd)
        v = _linear(h, params[pre + "attn_v.weight"], params[pre + "attn_v.bias"]).reshape(b, t, cfg.n_head, hd)
        kc, vc = cache[i]
        cache_write(kc, _rope_half_partial(k, cos, sin, cfg.n_rot).transpose(1, 2), cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(_rope_half_partial(q, cos, sin, cfg.n_rot).transpose(1, 2), kc, vc, keep,
                            1.0 / np.sqrt(hd))
        attn_out = _linear(out.to(dt), params[pre + "attn_output.weight"], params[pre + "attn_output.bias"])

        def mlp(z):
            f = F.gelu(_linear(z, params[pre + "ffn_up.weight"], params[pre + "ffn_up.bias"]))  # erf GELU
            return _linear(f, params[pre + "ffn_down.weight"], params[pre + "ffn_down.bias"])

        if cfg.parallel_residual:  # the MLP reads ln2 of the pre-block x, not x + attn
            return x + attn_out + mlp(_layer_norm(x, params[pre + "ffn_norm.weight"], params[pre + "ffn_norm.bias"],
                                                  cfg.eps))
        x = x + attn_out
        return x + mlp(_layer_norm(x, params[pre + "ffn_norm.weight"], params[pre + "ffn_norm.bias"], cfg.eps))

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
    return _linear(x, params["output.weight"], params.get("output.bias")), cache


class NeoX(FamilyModel):
    """Inference wrapper: prefill and on-device greedy or sampled decode
    (common.FamilyModel over neox.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a gptneox GGUF file onto `device`: quantized 2-D weights as
        planes (keep_quantized=False: dequantized to `dtype`)."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def gpt_neox_20b_config() -> NeoXConfig:
    """GPT-NeoX-20B at its published widths (EleutherAI/gpt-neox-20b
    config.json: vocab 50432, hidden 6144, 44 layers, 64 heads of 96,
    intermediate 24576, rotary_pct 0.25 (n_rot 24), rotary_emb_base 10000,
    layer_norm_eps 1e-5, use_parallel_residual true, 2048 positions;
    untied head)."""
    return NeoXConfig(n_vocab=50432, n_ctx=2048, n_embd=6144, n_head=64, n_layer=44, n_ff=24576, n_rot=24,
                      rope_base=10000.0, eps=1e-5, parallel_residual=True)


def write_random_gguf(path, cfg: NeoXConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K):
    """Write a gptneox file as llama.cpp's converter lays one out (the fused
    query_key_value split into attn_q/k/v): the keys config_from_gguf reads
    (use_parallel_residual as a bool), LayerNorms of ones with biases of std
    0.02, biased projections, an unbiased untied head (random_gguf.
    write_family_gguf: types, default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, f = cfg.n_embd, cfg.n_ff
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("block_count", cfg.n_layer), ("feed_forward_length", f),
            ("rope.dimension_count", cfg.n_rot), ("rope.freq_base", float(cfg.rope_base)),
            ("attention.layer_norm_epsilon", float(cfg.eps)), ("use_parallel_residual", bool(cfg.parallel_residual))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), "ones"),
               ("output_norm.bias", (d,), 0.02), ("output.weight", (cfg.n_vocab, d), "w")]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), "ones"), (pre + "attn_norm.bias", (d,), 0.02)]
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            tensors += [(pre + nm + ".weight", (d, d), "w"), (pre + nm + ".bias", (d,), 0.02)]
        tensors += [(pre + "ffn_norm.weight", (d,), "ones"), (pre + "ffn_norm.bias", (d,), 0.02),
                    (pre + "ffn_up.weight", (f, d), "w"), (pre + "ffn_up.bias", (f,), 0.02),
                    (pre + "ffn_down.weight", (d, f), "w"), (pre + "ffn_down.bias", (d,), 0.02)]
    write_family_gguf(path, "gptneox", keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
