"""The Gemma family (llama.cpp archs 'gemma', 'gemma2', 'gemma3') in PyTorch:
(1 + w) RMSNorms, the norm sandwich, GeGLU, logit softcapping and
interleaved sliding-window / global attention, over a tied head.

Port of ggml_tpu/models/gemma2.py, all three versions:

- the embedding is scaled by sqrt(n_embd) as an f32 number, so the residual
  stream is f32 even over bf16 weights (a numpy f32 scalar is not weakly
  typed in JAX: bf16 x f32 is f32), and every norm returns f32 with it;
- every norm multiplies by (1 + w) in f32 (Gemma2RMSNorm);
- gemma2 and gemma3 wrap each block in a sandwich, x += post_norm(block(
  pre_norm(x))); gemma1 has the pre-norms only;
- attention: rotate-half RoPE, scale query_pre_attn_scalar ** -0.5, the
  scores soft-capped before the mask (models/common.gqa_attention's
  softcap), f32 softmax; layer i slides (keys in (q - W, q]) unless i %
  sliding_pattern == sliding_pattern - 1 (gemma2 the even layers, gemma3
  five of every six, gemma1 none); sliding layers take rope_local_base
  where it is set, global ones rope_base over positions divided by
  rope_scale_global in f32;
- gemma3 normalizes q and k per head ((1 + w) RMSNorm) before RoPE;
- GeGLU (tanh gelu on the gate); the head is the token embedding (its dense
  copy where the embedding is planes), its f32 logits soft-capped.

The two keep masks (global and sliding) are computed once per forward, from
positions on the device, so a decode step runs in a CUDA graph; attention is
plain f32 PyTorch over the whole cache window, as JAX's einsums are.
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
from .gptj import rope_angles
from .llama import _rope_half

_ARCHS = ("gemma", "gemma2", "gemma3")


@dataclass(frozen=True)
class Gemma2Config:
    n_vocab: int = 256000
    n_ctx: int = 8192
    n_embd: int = 2304
    n_head: int = 8
    n_head_kv: int = 4
    head_dim: int = 256
    n_layer: int = 26
    n_ff: int = 9216
    rope_base: float = 10000.0
    rms_eps: float = 1e-6
    sliding_window: int = 4096
    attn_softcap: float = 50.0  # 0 disables (gemma3, gemma1)
    final_softcap: float = 30.0  # 0 disables (gemma3, gemma1)
    sandwich: bool = True  # False (gemma1): pre-norms only
    query_pre_attn_scalar: float = 256.0
    # gemma3: layers slide but every sliding_pattern-th, per-head q/k norms,
    # a local RoPE base, linear position scaling on the global layers
    sliding_pattern: int = 2
    qk_norm: bool = False
    rope_local_base: float = 0.0  # 0: rope_base everywhere
    rope_scale_global: float = 1.0


def config_from_gguf(g: GGUFFile) -> Gemma2Config:
    """The gemma/gemma2/gemma3 metadata with the JAX reader's keys and each
    version's defaults (gemma2.py:69-108)."""
    md = g.metadata
    a = md.get("general.architecture", "gemma2")
    if a not in _ARCHS:
        a = "gemma2"
    g3, g1 = a == "gemma3", a == "gemma"
    n_head = int(md[f"{a}.attention.head_count"])
    n_embd = int(md[f"{a}.embedding_length"])
    head_dim = int(md.get(f"{a}.attention.key_length", n_embd // n_head))
    return Gemma2Config(
        sandwich=not g1,
        sliding_pattern=int(md.get(f"{a}.attention.sliding_window_pattern", 6 if g3 else 2)),
        qk_norm=g3,
        rope_local_base=float(md.get(f"{a}.rope.local_freq_base", 10000.0 if g3 else 0.0)),
        rope_scale_global=float(md.get(f"{a}.rope.scaling.factor", 1.0)),
        n_vocab=int(md.get(f"{a}.vocab_size", 256000)),
        n_ctx=int(md[f"{a}.context_length"]),
        n_embd=n_embd,
        n_head=n_head,
        n_head_kv=int(md.get(f"{a}.attention.head_count_kv", n_head)),
        head_dim=head_dim,
        n_layer=int(md[f"{a}.block_count"]),
        n_ff=int(md[f"{a}.feed_forward_length"]),
        rope_base=float(md.get(f"{a}.rope.freq_base", 10000.0)),
        rms_eps=float(md.get(f"{a}.attention.layer_norm_rms_epsilon", 1e-6)),
        sliding_window=int(md.get(f"{a}.attention.sliding_window", 0 if g1 else 4096)),
        attn_softcap=float(md.get(f"{a}.attn_logit_softcapping", 0.0 if (g3 or g1) else 50.0)),
        final_softcap=float(md.get(f"{a}.final_logit_softcapping", 0.0 if (g3 or g1) else 30.0)),
        query_pre_attn_scalar=float(md.get(f"{a}.attention.query_pre_attn_scalar", head_dim)),
    )


def _rms_norm_gemma(x, w, eps):
    """Gemma2RMSNorm: normalized in f32, times (1 + w) in f32, cast back to
    x's type (gemma2.py:111-115)."""
    xf = x.float()
    v = torch.mean(xf ** 2, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps) * (1.0 + w.float())).to(x.dtype)


def _softcap(s, cap: float):
    return torch.tanh(s / cap) * cap


def init_cache(cfg: Gemma2Config, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda") -> list:
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head_kv, max_seq, cfg.head_dim, dtype, device)


def embed(params: dict, cfg: Gemma2Config, tokens: torch.Tensor) -> torch.Tensor:
    """The scaled embedding rows, f32 whatever the table's type: JAX
    multiplies by sqrt(n_embd) as a numpy f32 scalar, which promotes bf16."""
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    return embd[tokens].float() * float(np.float32(np.sqrt(cfg.n_embd)))


def layer_rope(cfg: Gemma2Config, i: int, positions: torch.Tensor):
    """(sliding, cos, sin) of layer i at positions (b, t): the local base on
    sliding layers where the config has one, positions divided by
    rope_scale_global in f32 on global ones (gemma2.py:158-162)."""
    sliding = i % cfg.sliding_pattern != cfg.sliding_pattern - 1
    base = cfg.rope_local_base if (sliding and cfg.rope_local_base) else cfg.rope_base
    rp = positions if (sliding or cfg.rope_scale_global == 1.0) else positions.float() / cfg.rope_scale_global
    return sliding, *rope_angles(rp, cfg.head_dim, base)


def attention_inputs(params: dict, pre: str, h, cos, sin, cfg: Gemma2Config):
    """q (b, t, H, d) and k (b, t, H_kv, d) after gemma3's q/k norms and
    RoPE, and v (b, t, H_kv, d), from the normed input h (b, t, E)."""
    b, t = h.shape[:2]
    hd = cfg.head_dim
    q = _linear(h, params[pre + "attn_q.weight"]).reshape(b, t, cfg.n_head, hd)
    k = _linear(h, params[pre + "attn_k.weight"]).reshape(b, t, cfg.n_head_kv, hd)
    v = _linear(h, params[pre + "attn_v.weight"]).reshape(b, t, cfg.n_head_kv, hd)
    if cfg.qk_norm:  # gemma3: per-head (1 + w) RMSNorm before RoPE
        q = _rms_norm_gemma(q, params[pre + "attn_q_norm.weight"], cfg.rms_eps)
        k = _rms_norm_gemma(k, params[pre + "attn_k_norm.weight"], cfg.rms_eps)
    return _rope_half(q, cos, sin), _rope_half(k, cos, sin), v


def block_tail(params: dict, pre: str, x, attn_out, cfg: Gemma2Config):
    """The rest of a layer after attention: the output projection and its
    post-norm into the residual, then the GeGLU block in its sandwich."""
    o = _linear(attn_out, params[pre + "attn_output.weight"])
    x = x + (_rms_norm_gemma(o, params[pre + "attn_post_norm.weight"], cfg.rms_eps) if cfg.sandwich else o)
    h = _rms_norm_gemma(x, params[pre + "ffn_norm.weight"], cfg.rms_eps)
    gate = _linear(h, params[pre + "ffn_gate.weight"])
    up = _linear(h, params[pre + "ffn_up.weight"])
    f = _linear(F.gelu(gate, approximate="tanh") * up, params[pre + "ffn_down.weight"])
    return x + (_rms_norm_gemma(f, params[pre + "ffn_post_norm.weight"], cfg.rms_eps) if cfg.sandwich else f)


def final_logits(params: dict, x, cfg: Gemma2Config):
    """The final norm, the tied head (the embedding's dense copy where it is
    planes, or an output.weight where the file has one) in f32, and the final
    softcap (gemma2.py:201-206)."""
    x = _rms_norm_gemma(x, params["output_norm.weight"], cfg.rms_eps)
    w_out = params.get("output.weight", params.get("token_embd.weight@dense", params["token_embd.weight"]))
    logits = _linear(x, w_out).float()
    return _softcap(logits, cfg.final_softcap) if cfg.final_softcap else logits


def forward(params: dict, cfg: Gemma2Config, tokens: torch.Tensor, pos_start: torch.Tensor, cache: list,
            cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True, layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab) f32, cache), the cache written
    in place (gemma2.py:122-207).  pos_start (b,) and cache_len (0-d or (b,))
    are integer tensors on the model's device; need_logits=False skips the
    final norm and the head: (None, cache).  prefill is accepted for the
    family signature (attention always reads the cache window).
    layer_remat: each layer rematerialized (common.run_layers)."""
    del prefill
    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    x = embed(params, cfg, tokens)
    dt = x.dtype
    scale = cfg.query_pre_attn_scalar ** -0.5
    rows = cache_rows(cache_len, t, max_seq)
    keep = window_keep(positions, max_seq)
    keep_sliding = window_keep(positions, max_seq, cfg.sliding_window) if cfg.sliding_window else keep

    def layer(i, x):
        pre = f"blk.{i}."
        sliding, cos, sin = layer_rope(cfg, i, positions)
        q, k, v = attention_inputs(params, pre, _rms_norm_gemma(x, params[pre + "attn_norm.weight"], cfg.rms_eps),
                                   cos, sin, cfg)
        kc, vc = cache[i]
        cache_write(kc, k.transpose(1, 2), cache_len, rows)
        cache_write(vc, v.transpose(1, 2), cache_len, rows)
        out = gqa_attention(q.transpose(1, 2), kc, vc, keep_sliding if sliding else keep, scale,
                            softcap=cfg.attn_softcap)
        return block_tail(params, pre, x, out.to(dt), cfg)

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    return final_logits(params, x, cfg), cache


class Gemma2(FamilyModel):
    """Inference wrapper for gemma, gemma2 and gemma3 files: prefill and
    on-device greedy or sampled decode (common.FamilyModel over
    gemma2.forward)."""

    def _forward(self, *args, **kw):
        return forward(*args, **kw)

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, device="cuda", **kw):
        """Load a gemma, gemma2 or gemma3 GGUF file onto `device`: quantized
        2-D weights as planes (keep_quantized=False: every tensor dequantized
        to `dtype`), the embedding also dense for the row gather and the
        tied head."""
        from .gpt2 import load_params

        with GGUFFile(path) as g:
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
            cfg = config_from_gguf(g)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.bfloat16):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)


def gemma2_9b_config() -> Gemma2Config:
    """Gemma-2-9B at its published widths (google/gemma-2-9b config.json:
    vocab 256000, hidden 3584, 42 layers, 16 heads over 8 kv heads, head_dim
    256, intermediate 14336, sliding_window 4096, attn_logit_softcapping 50,
    final_logit_softcapping 30, query_pre_attn_scalar 256, rope_theta 10000,
    rms_norm_eps 1e-6, 8192 positions; tied head)."""
    return Gemma2Config(n_vocab=256000, n_ctx=8192, n_embd=3584, n_head=16, n_head_kv=8, head_dim=256, n_layer=42,
                        n_ff=14336, rope_base=10000.0, rms_eps=1e-6, sliding_window=4096, attn_softcap=50.0,
                        final_softcap=30.0, query_pre_attn_scalar=256.0)


def gemma3_12b_config() -> Gemma2Config:
    """Gemma-3-12B's text model at its published widths (google/gemma-3-12b-pt
    config.json, text_config: vocab 262208, hidden 3840, 48 layers, 16 heads
    over 8 kv heads, head_dim 256, intermediate 15360, sliding_window 1024
    with sliding_window_pattern 6, rope_theta 1e6 with linear scaling factor
    8 on the global layers, rope_local_base_freq 10000, per-head q/k norms,
    query_pre_attn_scalar 256, no softcaps, rms_norm_eps 1e-6, 131072
    positions; tied head)."""
    return Gemma2Config(n_vocab=262208, n_ctx=131072, n_embd=3840, n_head=16, n_head_kv=8, head_dim=256,
                        n_layer=48, n_ff=15360, rope_base=1e6, rms_eps=1e-6, sliding_window=1024, attn_softcap=0.0,
                        final_softcap=0.0, query_pre_attn_scalar=256.0, sliding_pattern=6, qk_norm=True,
                        rope_local_base=10000.0, rope_scale_global=8.0)


def write_random_gguf(path, cfg: Gemma2Config, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None, default_type: GGMLType = GGMLType.Q4_K, arch: str = "gemma2"):
    """Write a gemma, gemma2 or gemma3 file (arch) as llama.cpp's converter
    lays one out: the keys config_from_gguf reads (for gemma1 no window and
    no softcaps), norm weights F32 of std 0.02 (the (1 + w) form reads them
    near 1), per-head q/k norms for gemma3, post-norms unless gemma1, and no
    output.weight: the head is the embedding (random_gguf.write_family_gguf:
    types, default_type, the fallbacks)."""
    from .random_gguf import write_family_gguf

    d, f, hd = cfg.n_embd, cfg.n_ff, cfg.head_dim
    nq, nkv = cfg.n_head * hd, cfg.n_head_kv * hd
    keys = [("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx), ("embedding_length", d),
            ("attention.head_count", cfg.n_head), ("attention.head_count_kv", cfg.n_head_kv),
            ("attention.key_length", hd), ("attention.value_length", hd), ("block_count", cfg.n_layer),
            ("feed_forward_length", f), ("rope.freq_base", float(cfg.rope_base)),
            ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps)),
            ("attention.query_pre_attn_scalar", float(cfg.query_pre_attn_scalar))]
    if arch != "gemma":
        keys += [("attention.sliding_window", cfg.sliding_window),
                 ("attention.sliding_window_pattern", cfg.sliding_pattern)]
    if arch == "gemma2":
        keys += [("attn_logit_softcapping", float(cfg.attn_softcap)),
                 ("final_logit_softcapping", float(cfg.final_softcap))]
    if arch == "gemma3":
        keys += [("rope.local_freq_base", float(cfg.rope_local_base)),
                 ("rope.scaling.factor", float(cfg.rope_scale_global))]
    tensors = [("token_embd.weight", (cfg.n_vocab, d), "w"), ("output_norm.weight", (d,), 0.02)]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        tensors += [(pre + "attn_norm.weight", (d,), 0.02), (pre + "attn_q.weight", (nq, d), "w"),
                    (pre + "attn_k.weight", (nkv, d), "w"), (pre + "attn_v.weight", (nkv, d), "w")]
        if arch == "gemma3":
            tensors += [(pre + "attn_q_norm.weight", (hd,), 0.02), (pre + "attn_k_norm.weight", (hd,), 0.02)]
        tensors.append((pre + "attn_output.weight", (d, nq), "w"))
        if arch != "gemma":
            tensors.append((pre + "attn_post_norm.weight", (d,), 0.02))
        tensors += [(pre + "ffn_norm.weight", (d,), 0.02), (pre + "ffn_gate.weight", (f, d), "w"),
                    (pre + "ffn_up.weight", (f, d), "w"), (pre + "ffn_down.weight", (d, f), "w")]
        if arch != "gemma":
            tensors.append((pre + "ffn_post_norm.weight", (d,), 0.02))
    write_family_gguf(path, arch, keys, tensors, seed=seed, tokenizer=tokenizer, types=types,
                      default_type=default_type)
