"""GPT-J 6B — the north-star quantized decode config, in PyTorch.

Port of ggml_tpu/models/gptj.py (reference: examples/gpt-j/main.cpp):
parallel residual (attn and mlp both read the SAME post-layernorm
activations, main.cpp:449-565), separate unbiased q/k/v projections, RoPE on
the first n_rot dims (ggml rope mode 0), biased mlp and biased untied lm head.

- quantized weights stay planes in device memory (packed nibbles for
  Q4_0/Q4_1/Q2_K/Q3_K/Q4_K, int8 planes for Q8_0/Q5_0/Q5_1/Q5_K/Q6_K) and run
  through the hand-written kernels of ggml_tpu_torch.kernels.qmatmul;
- single-token steps run attention through kernels.decode_attn, prompts of
  flash_min_seq tokens or more through kernels.flash_attn;
- the KV cache is written in place (the JAX package donates it to XLA);
- decode keeps its position and tokens on the device and, on the card, runs
  as one CUDA graph replay a token (models/common.DecodeGraph, the JAX
  package's jitted scan), so it never waits for the host until the ids are
  returned.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (QuantKV, cache_rows, cache_write, causal_mask, decode_loop, dequant_cache, init_layer_cache,
                     layer_norm as _layer_norm, linear as _linear, make_sampled_decode, run_layers)
from .gpt2 import _gelu_fp16


@dataclass(frozen=True)
class GPTJConfig:
    n_vocab: int = 50400
    n_ctx: int = 2048
    n_embd: int = 4096
    n_head: int = 16
    n_layer: int = 28
    n_rot: int = 64
    eps: float = 1e-5
    # prompts of flash_min_seq tokens or more (or any prompt with
    # use_flash_prefill) take the flash-attention prefill
    use_flash_prefill: bool = False
    flash_min_seq: int = 1024
    # the reference CPU's fp16-table gelu (GGML_GELU_FP16): out = fp16(gelu(fp16(x)))
    gelu_fp16: bool = False
    # q/k weight columns were permuted at load (rope_permutation) so RoPE
    # runs deinterleaved — see _rope_deinterleaved
    rope_deinterleaved: bool = False

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> GPTJConfig:
    md = g.metadata
    return GPTJConfig(
        n_vocab=int(md.get("gptj.vocab_size", 50400)),
        n_ctx=int(md["gptj.context_length"]),
        n_embd=int(md["gptj.embedding_length"]),
        n_head=int(md["gptj.attention.head_count"]),
        n_layer=int(md["gptj.block_count"]),
        n_rot=int(md.get("gptj.rope.dimension_count", 64)),
    )


@functools.cache
def _inv_freq(n_rot: int, base: float, device: torch.device) -> torch.Tensor:
    """RoPE frequencies, computed in float64 on the host as the JAX package
    does, copied to the device once (a host-to-device copy per step would
    make the decode loop wait for the device).  Never evicted: a captured
    decode graph reads the tensor."""
    half = n_rot // 2
    return torch.from_numpy((base ** (-2.0 * np.arange(half) / n_rot)).astype(np.float32)).to(device)


def rope_angles(positions, n_rot: int, base: float = 10000.0):
    """cos, sin (b, t, 1, n_rot/2) f32 of ggml rope mode 0 at positions
    (b, t); computed once per forward and shared by every layer's q and k."""
    theta = positions.float()[..., None] * _inv_freq(n_rot, base, positions.device)[None, None, :]
    return torch.cos(theta)[:, :, None, :], torch.sin(theta)[:, :, None, :]


def _rope_interleaved(x, cos, sin, n_rot: int):
    """ggml rope mode 0 (GPT-J interleaved pairs) on the first n_rot dims.
    x: (b, t, h, d); cos/sin from rope_angles."""
    rot, rest = x[..., :n_rot], x[..., n_rot:]
    x0 = rot[..., 0::2]
    x1 = rot[..., 1::2]
    o0 = x0 * cos - x1 * sin
    o1 = x0 * sin + x1 * cos
    out = torch.stack([o0, o1], dim=-1).reshape(o0.shape[:-1] + (n_rot,))
    return torch.cat([out, rest.to(out.dtype)], dim=-1) if rest.shape[-1] else out


def _rope_deinterleaved(x, cos, sin, n_rot: int):
    """Mode-0 RoPE in a DEINTERLEAVED head layout: the q/k weight output
    columns were permuted at load (rope_permutation) so logical pair
    (2j, 2j+1) lives at dims (j, j+n_rot/2).  Attention dots are invariant to
    the fixed per-head permutation because q and k are permuted identically;
    v is untouched."""
    half = n_rot // 2
    x0, x1, rest = x[..., :half], x[..., half:n_rot], x[..., n_rot:]
    o0 = x0 * cos - x1 * sin
    o1 = x0 * sin + x1 * cos
    parts = (o0, o1, rest.to(o0.dtype)) if rest.shape[-1] else (o0, o1)
    return torch.cat(parts, dim=-1)


def rope_permutation(head_dim: int, n_head: int, n_rot: int) -> np.ndarray:
    """Output-feature permutation that moves each head's even rotary dims
    first and odd second ([0,2,..,n_rot-2, 1,3,..,n_rot-1, n_rot..]) so
    _rope_deinterleaved applies mode-0 RoPE with contiguous slices."""
    within = np.concatenate([
        np.arange(0, n_rot, 2), np.arange(1, n_rot, 2), np.arange(n_rot, head_dim)
    ])
    return (np.arange(n_head)[:, None] * head_dim + within[None, :]).reshape(-1)


def init_cache(cfg: GPTJConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head, max_seq, cfg.head_dim, dtype, device)


def forward(params: dict, cfg: GPTJConfig, tokens: torch.Tensor, pos_start: torch.Tensor,
            cache: list, cache_len: torch.Tensor, *, prefill: bool = False, need_logits: bool = True,
            layer_remat=None):
    """tokens (b, t) -> (logits (b, t, n_vocab), cache); the cache is updated
    in place and returned, as the JAX forward returns its new cache.

    pos_start (b,) and cache_len are integer tensors on the model's device;
    cache_len is 0-d (the whole batch at one position) or (b,) (a position
    per row: the serving engine's step, which attends in plain PyTorch as
    the JAX forward does; kernel D takes only t == 1, b == 1 at a 0-d
    position, gptj.py:179).  need_logits=False skips the final norm and the
    head and returns (None, cache).  prefill=True asserts that the cache is
    empty below pos_start — only then may a flash path attend just the
    current tokens.  Differentiable
    (training from an empty cache, opt/finetune.make_lm_model_fn): with t > 1
    and prefill=False attention is the plain f32 attention over the cache
    window, whose rows autograd reads back through the in-place writes.
    layer_remat: each layer rematerialized (common.run_layers)."""
    from ..kernels.decode_attn import fused_decode_attention

    b, t = tokens.shape
    max_seq = cache[0][0].shape[-2]
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens]
    compute_dtype = x.dtype
    cache_dtype = cache[0][0].dtype
    scale = 1.0 / np.sqrt(cfg.head_dim)
    rope = _rope_deinterleaved if cfg.rope_deinterleaved else _rope_interleaved
    cos, sin = rope_angles(positions, cfg.n_rot)
    rows = cache_rows(cache_len, t, max_seq)  # cache rows written
    flash = t > 1 and prefill and (cfg.use_flash_prefill or t >= cfg.flash_min_seq)
    if flash:
        # prefill from an empty cache attends the current tokens only, through
        # the flash kernel (the cache holds no history by contract); every
        # layer reads the same mask, so its tile ranges are computed once
        from ..kernels.flash_attn import flash_attention, mask_ranges

        mask = causal_mask(t, x.device)
        ranges = mask_ranges(mask)
    def layer(i, x):
        pre = f"blk.{i}."
        h = _layer_norm(x, params[pre + "attn_norm.weight"], params[pre + "attn_norm.bias"], cfg.eps)

        ff_pre = None
        if pre + "attn_qkvup.weight" in params:  # qkv + ffn_up in ONE kernel
            fused = _linear(h, params[pre + "attn_qkvup.weight"])
            q, k, v, ff_pre = torch.split(fused, [cfg.n_embd, cfg.n_embd, cfg.n_embd, 4 * cfg.n_embd], dim=-1)
        else:  # separate projections, as a GGUF file stores them
            q = _linear(h, params[pre + "attn_q.weight"])
            k = _linear(h, params[pre + "attn_k.weight"])
            v = _linear(h, params[pre + "attn_v.weight"])

        def heads(z):
            return z.reshape(b, t, cfg.n_head, cfg.head_dim)

        q = rope(heads(q), cos, sin, cfg.n_rot).transpose(1, 2)
        k = rope(heads(k), cos, sin, cfg.n_rot).transpose(1, 2)
        v = heads(v).transpose(1, 2)
        kc, vc = cache[i]

        fuse_decode = t == 1 and b == 1 and cache_len.dim() == 0 and not isinstance(kc, QuantKV)
        if fuse_decode:
            # single-token decode: the attention block runs as ONE kernel per
            # layer over the PRE-update cache with the new row inserted
            out = fused_decode_attention(q.contiguous(), k.to(cache_dtype).contiguous(),
                                         v.to(cache_dtype).contiguous(), kc, vc, cache_len, scale=scale)
            attn_out = out.transpose(1, 2).reshape(b, t, cfg.n_embd).to(compute_dtype)

        cache_write(kc, k, cache_len, rows)
        cache_write(vc, v, cache_len, rows)

        if fuse_decode:
            pass
        elif flash:
            # in a bf16 model RoPE leaves q and k in f32 beside a bf16 v; they
            # go in as they are (the scores come from the f32 values, as in
            # the JAX kernel) and the output comes back in f32
            out = flash_attention(q, k, v, mask=mask, scale=scale, ranges=ranges)
            attn_out = out.reshape(b, t, cfg.n_embd).to(compute_dtype)
        else:
            # plain f32 attention over the whole cache window (gptj.py:211-222;
            # a q8 cache dequantized on read), a named range for the profiler
            # (the training step's breakdown)
            with torch.profiler.record_function("gptj.attention"):
                kd, vd = dequant_cache(kc), dequant_cache(vc)
                att = torch.matmul(q.float(), kd.float().transpose(-1, -2)) * scale
                kv_pos = torch.arange(max_seq, device=x.device)[None, None, None, :]
                q_pos = positions[:, None, :, None]
                att = torch.where(kv_pos <= q_pos, att, torch.full((), float("-inf"), device=x.device))
                att = torch.softmax(att, dim=-1).to(vd.dtype)
                out = torch.matmul(att, vd)
                attn_out = out.transpose(1, 2).reshape(b, t, cfg.n_embd).to(compute_dtype)
        attn_out = _linear(attn_out, params[pre + "attn_output.weight"])

        # parallel residual: mlp reads the SAME normed input (main.cpp:538-541)
        if ff_pre is not None:
            ff = ff_pre + params[pre + "ffn_up.bias"]
        else:
            ff = _linear(h, params[pre + "ffn_up.weight"], params[pre + "ffn_up.bias"])
        if cfg.gelu_fp16:
            ff = _gelu_fp16(ff)
        else:
            ff = 0.5 * ff * (1.0 + torch.tanh(0.79788456080286535588 * ff * (1.0 + 0.044715 * ff * ff)))
        ff = _linear(ff, params[pre + "ffn_down.weight"], params[pre + "ffn_down.bias"])

        return x + attn_out + ff

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
    return _linear(x, params["output.weight"], params.get("output.bias")), cache


class GPTJ:
    """Inference wrapper: prefill + on-device greedy or sampled decode."""

    def __init__(self, params: dict, cfg: GPTJConfig, max_seq: int = 2048, batch: int = 1,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.batch = batch
        self.device = torch.device(device)
        self.decode_graphs: dict = {}  # cache dtype -> common.DecodeGraph, made at the first graphed decode

    @classmethod
    def from_gguf(cls, path, dtype=torch.bfloat16, keep_quantized: bool = True, rope_deinterleaved: bool = True,
                  device="cuda", **kw):
        """Load a GGUF file onto `device`: its quantized matmul weights (Q4_0,
        Q4_1, Q2_K, Q3_K, Q4_K, Q8_0, Q5_0, Q5_1, Q5_K, Q6_K, the IQ* and TQ*
        types, alone or mixed) stay planes, or, with keep_quantized=False,
        every tensor is dequantized to `dtype`."""
        from ..quant.planar import PlanarWeight, permute_output_columns
        from .gpt2 import load_params  # same GGUF tensor-naming loader

        with GGUFFile(path) as g:
            cfg = config_from_gguf(g)
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
        if rope_deinterleaved:
            # on-load q/k column permutation -> contiguous-slice RoPE on the
            # decode hot path (exact: see _rope_deinterleaved)
            perm = rope_permutation(cfg.head_dim, cfg.n_head, cfg.n_rot)
            for i in range(cfg.n_layer):
                for nm in ("attn_q.weight", "attn_k.weight"):
                    key = f"blk.{i}.{nm}"
                    v = params[key]
                    params[key] = (permute_output_columns(v, perm) if isinstance(v, PlanarWeight)
                                   else v[torch.from_numpy(perm).to(v.device)])
            cfg = dataclasses.replace(cfg, rope_deinterleaved=True)
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


def random_config(scale: str = "6b") -> GPTJConfig:
    """The GPT-J-6B config for synthesized weights, or a tiny one (E=256: its
    Q4_K weights are non-compact nibble planes with 4 groups per half-plane,
    which take the matmul kernel at every M).  rope_deinterleaved: synthetic
    codes are value-free, so the synthetic model takes the contiguous-slice
    RoPE path directly."""
    if scale == "6b":
        return GPTJConfig(rope_deinterleaved=True)
    if scale == "tiny":
        return GPTJConfig(n_vocab=512, n_ctx=256, n_embd=256, n_head=4, n_layer=2, n_rot=32,
                          rope_deinterleaved=True)
    raise ValueError(scale)


# the types synth_quantized_params builds planes for
_SYNTH_TYPES = {GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_0,
                GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.Q5_K, GGMLType.Q6_K}


def synth_planar_weight(n: int, k: int, ggml_type: GGMLType, gen, device="cuda",
                        use_q4: bool | None = None):
    """One (n, k) weight of synth_quantized_params's planes: random codes
    drawn from the torch.Generator gen on `device`, constant scales (every
    weight's effective scale 0.0025, offset -0.02 where the type is affine),
    N padded to 128 (to 2048 above 8192 rows)."""
    from ..quant.planar import _Q4_PLANE_TYPES, PlanarWeight, _compact_applicable

    ggml_type = GGMLType(ggml_type)
    if ggml_type not in _SYNTH_TYPES:
        raise NotImplementedError(f"synthetic {ggml_type.name} planes are not ported (the IQ* and TQ* types load "
                                  "from GGUF files: write_random_gguf(types=))")
    if use_q4 is None:
        use_q4 = ggml_type in _Q4_PLANE_TYPES
    elif use_q4 and ggml_type not in _Q4_PLANE_TYPES:
        raise ValueError(f"{ggml_type.name} codes do not fit a 4-bit plane")
    G = 16 if ggml_type in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q6_K) else 32
    SB = 8
    affine = ggml_type in _Q4_PLANE_TYPES or ggml_type == GGMLType.Q5_K
    s_val = np.float32(0.02 / 8)
    sdt = torch.bfloat16  # scales, offsets, d and dmin in bf16, as the JAX synthesis stores them
    pad_to = 2048 if n > 8192 else 128
    npad = -(-n // pad_to) * pad_to
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    offsets = full((k // G, npad), float(-8.0 * s_val), sdt) if affine else None
    if not use_q4:
        return PlanarWeight(
            kind="q8", group=G, n=n, k=k, orig_type=ggml_type,
            codes=torch.randint(-128, 128, (k, npad), dtype=torch.int8, device=device, generator=gen),
            scales=full((k // G, npad), float(s_val), sdt), offsets=offsets)
    if not _compact_applicable(ggml_type, k):
        return PlanarWeight(
            kind="q4", group=G, n=n, k=k, orig_type=ggml_type, sb=SB,
            codes=torch.randint(0, 256, (k // 2, npad), dtype=torch.uint8, device=device, generator=gen),
            scales=full((2, (k // 2) // G, npad), float(s_val), sdt), offsets=offsets)
    sup = (2, (k // 2) // (G * SB), npad)
    return PlanarWeight(
        kind="q4", group=G, n=n, k=k, orig_type=ggml_type, sb=SB,
        codes=torch.randint(0, 256, (k // 2, npad), dtype=torch.uint8, device=device, generator=gen),
        scales=full((2, (k // 2) // G, npad), 32, torch.int8),
        offsets=full((k // G, npad), 32, torch.int8),
        supers=(full(sup, float(s_val / 32), sdt), full(sup, float(8.0 * s_val / 32), sdt)))


def synth_quantized_params(cfg: GPTJConfig, ggml_type: GGMLType = GGMLType.Q4_K, seed: int = 0,
                           dtype=torch.bfloat16, device="cuda", use_q4: bool | None = None) -> dict:
    """A full parameter set with weights ALREADY in planes (random codes,
    constant scales) made on `device` from a torch.Generator — for running
    the quantized path at full width without a checkpoint.  Planes as the
    JAX package's synth_quantized_params builds them:

    - Q4_0, Q4_1, Q2_K, Q3_K, Q4_K (use_q4, the default for them):
      packed-nibble planes, every weight's effective scale 0.0025 and offset
      -0.02: compact planes for Q4_K at K % 512 == 0, else one bf16 scale and
      offset per group of 32 (16 for Q2_K and Q3_K);
    - Q8_0, Q5_0, Q5_1, Q5_K, Q6_K, and the five above with use_q4=False: int8
      codes over the full int8 range with one bf16 scale 0.0025 per group of
      32 (16 for Q2_K, Q3_K and Q6_K) and, for the affine types, a bf16 offset
      -0.02.

    Each layer holds one (7E x E) qkv+ffn_up weight, the JAX default layout:
    with the parallel residual, qkv and ffn_up read the same h."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 7)
    qweight = lambda n, k: synth_planar_weight(n, k, ggml_type, gen, device, use_q4)

    E = cfg.n_embd
    dgen = torch.Generator(device=device)
    dgen.manual_seed(seed)
    embd = (torch.randn((cfg.n_vocab, E), generator=dgen, device=device) * 0.02).to(dtype)
    ones_e = torch.ones((E,), dtype=dtype, device=device)
    zeros_e = torch.zeros((E,), dtype=dtype, device=device)
    zeros_4e = torch.zeros((4 * E,), dtype=dtype, device=device)
    p = {
        "token_embd.weight": embd,
        "output_norm.weight": ones_e,
        "output_norm.bias": zeros_e,
        "output.weight": qweight(cfg.n_vocab, E),
        "output.bias": torch.zeros((cfg.n_vocab,), dtype=dtype, device=device),
    }
    layer = [("attn_qkvup.weight", 7 * E, E), ("attn_output.weight", E, E), ("ffn_down.weight", E, 4 * E)]
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        for name, n, k in layer:
            p[pre + name] = qweight(n, k)
        p[pre + "attn_norm.weight"] = ones_e
        p[pre + "attn_norm.bias"] = zeros_e
        p[pre + "ffn_up.bias"] = zeros_4e
        p[pre + "ffn_down.bias"] = zeros_e
    return p


# The block scale d that random_blocks draws (in [s/2, 3s/2)) for each type
# write_random_gguf writes: weights of about a trained model's std, 0.02,
# measured over random blocks of each type.
_RANDOM_GGUF_SCALE = {
    GGMLType.Q4_K: 8e-5, GGMLType.Q6_K: 1.4e-5, GGMLType.Q5_0: 2.1e-3, GGMLType.Q8_0: 2.6e-4, GGMLType.IQ4_NL: 2.9e-4, GGMLType.IQ4_XS: 1.5e-5, GGMLType.IQ3_S: 1.3e-4,
    GGMLType.IQ3_XXS: 1.3e-4, GGMLType.IQ2_S: 3.4e-4, GGMLType.IQ2_XS: 3.4e-4, GGMLType.IQ2_XXS: 3.6e-4,
    GGMLType.IQ1_M: 2.7e-3, GGMLType.IQ1_S: 2.7e-3, GGMLType.TQ2_0: 2.7e-2, GGMLType.TQ1_0: 2.3e-2,
}


def matmul_weight_names(cfg: GPTJConfig) -> list[str]:
    """The 2-D matmul weights of a GPT-J GGUF file, in file order."""
    names = ["token_embd.weight", "output.weight"]
    for i in range(cfg.n_layer):
        names += [f"blk.{i}.{nm}.weight" for nm in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_up", "ffn_down")]
    return names


def _random_weight_blocks(t: GGMLType, n: int, k: int, rng) -> np.ndarray:
    """Random blocks of an (n, k) weight of type t with zero-mean weights of
    std about 0.02: Q4_K's dmin is 7.5 d; TQ2_0's code 3 (the value +2,
    which its quantizer never writes) becomes 1 (the value 0)."""
    from ..dtypes import get_type_traits
    from ..quant.reference import random_blocks

    if t not in _RANDOM_GGUF_SCALE:
        raise ValueError(f"write_random_gguf writes Q4_K, Q6_K, Q5_0, Q8_0 and the IQ* and TQ* types, not {t.name}")
    b = random_blocks(t, n * k // get_type_traits(t).block_size, rng, scale=_RANDOM_GGUF_SCALE[t])
    if t == GGMLType.Q4_K:
        d = b[:, 0:2].copy().view("<f2").astype(np.float32)
        b[:, 2:4] = (d * np.float32(7.5)).astype("<f2").view(np.uint8)
    elif t == GGMLType.TQ2_0:
        qs = b[:, 0:64]
        b[:, 0:64] = qs & ~(((qs >> 1) & qs & 0x55) << 1)
    return b


def write_random_gguf(path, cfg: GPTJConfig, seed: int = 0, tokenizer: dict | None = None,
                      types: dict | None = None):
    """Write a GPT-J GGUF file as tools/convert_hf_gptj.py lays one out, its
    2-D matmul weights blocks from quant/reference.random_blocks, the norms
    (ones) and biases (zeros) F32 — a file for running the GGUF path at any
    width without a checkpoint.

    types: a map from weight names (matmul_weight_names) to types; Q4_K for
    a weight it does not name.
    Each block's d is drawn in [s/2, 3s/2) (random_blocks) with s chosen
    so that the weights have a std of about 0.02, a trained model's scale:
    Q4_K 8e-5 (with dmin = 7.5 d, which centres d * (sc * q - 7.5 m) on
    zero), Q6_K 1.4e-5, IQ4_NL 2.9e-4, IQ4_XS 1.5e-5, IQ3_S and IQ3_XXS 1.3e-4, IQ2_S and
    IQ2_XS 3.4e-4, IQ2_XXS 3.6e-4, IQ1_M and IQ1_S 2.7e-3, TQ1_0 2.3e-2,
    TQ2_0 2.7e-2 (its codes ternary: -1, 0, 0, 1 for the four 2-bit
    values).  tokenizer: GGUF tokenizer.ggml.* keys (without the prefix) ->
    values, written as they are."""
    from ..gguf import GGUFWriter

    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    w.add_string("general.architecture", "gptj")
    for key, val in (("context_length", cfg.n_ctx), ("embedding_length", cfg.n_embd),
                     ("attention.head_count", cfg.n_head), ("block_count", cfg.n_layer),
                     ("vocab_size", cfg.n_vocab), ("rope.dimension_count", cfg.n_rot)):
        w.add_u32(f"gptj.{key}", val)
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

    def f32(name, value, n):
        w.add_tensor(name, np.full((n,), value, np.float32))

    E = cfg.n_embd
    weight("token_embd.weight", cfg.n_vocab, E)
    f32("output_norm.weight", 1.0, E)
    f32("output_norm.bias", 0.0, E)
    weight("output.weight", cfg.n_vocab, E)
    f32("output.bias", 0.0, cfg.n_vocab)
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        f32(pre + "attn_norm.weight", 1.0, E)
        f32(pre + "attn_norm.bias", 0.0, E)
        for name in ("attn_q", "attn_k", "attn_v", "attn_output"):
            weight(pre + name + ".weight", E, E)
        weight(pre + "ffn_up.weight", 4 * E, E)
        f32(pre + "ffn_up.bias", 0.0, 4 * E)
        weight(pre + "ffn_down.weight", E, 4 * E)
        f32(pre + "ffn_down.bias", 0.0, E)
    w.write(path)
