"""GPT-2 in PyTorch (port of ggml_tpu/models/gpt2.py; reference:
examples/gpt-2/main-backend.cpp), and the GGUF tensor-naming loader the
GPT-2-style families share.

- forward runs from the KV cache (attention over the whole cache window,
  differentiable: the cache rows are written in place with index_copy_, which
  autograd records), or, for training from an empty cache (train_flash), through
  the differentiable flash-attention kernels K, L and M, without touching the
  cache (under jit the JAX package's cache writes there are dead code);
- weights are dense (f32/bf16), or planes in device memory where a GGUF file
  is loaded with keep_quantized;
- the tied LM head multiplies by the token embedding.

Linear weights are (out_features, in_features), applied as x @ W^T.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..dtypes import GGMLType
from ..gguf import GGUFFile
from .common import (cache_rows, cache_write, causal_mask, decode_loop, init_layer_cache, layer_norm as _layer_norm,
                     linear as _linear, run_layers)


@dataclass(frozen=True)
class GPT2Config:
    n_vocab: int = 50257
    n_ctx: int = 1024
    n_embd: int = 768
    n_head: int = 12
    n_layer: int = 12
    eps: float = 1e-5
    # the reference CPU backend's gelu through an fp16 table (GGML_GELU_FP16):
    # out = fp16(gelu(fp16(x))); off by default
    gelu_fp16: bool = False

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def config_from_gguf(g: GGUFFile) -> GPT2Config:
    md = g.metadata
    return GPT2Config(
        n_vocab=int(md.get("gpt2.vocab_size", md.get("tokenizer.ggml.tokens") and len(md["tokenizer.ggml.tokens"]) or 50257)),
        n_ctx=int(md["gpt2.context_length"]),
        n_embd=int(md["gpt2.embedding_length"]),
        n_head=int(md["gpt2.attention.head_count"]),
        n_layer=int(md["gpt2.block_count"]),
    )


_CHUNK_ROWS = 8192  # rows a dequantization or repack job of load_params takes at most (whole experts, at least one)


def _dequantize_rows(g: GGUFFile, name: str, out: torch.Tensor, r0: int, r1: int):
    """Rows [r0, r1) of a tensor's (rows, K) view, its leading dims
    flattened (a stack of experts is its experts' rows, as ggml stores it),
    dequantized and copied into out[r0:r1], a view of the load's type and
    device.  On a CUDA device the types of quant/torch_dequant.py are
    decoded there from their raw blocks (the same values bit for bit); the
    rest in numpy on the host."""
    from ..dtypes import row_size
    from ..quant import torch_dequant
    from ..quant.reference import dequantize

    info = g.tensors[name]
    t, k = GGMLType(info.ggml_type), int(info.shape[-1])
    rb = row_size(t, k)
    raw = g.tensor_bytes(name)[r0 * rb:r1 * rb]
    if out.device.type == "cuda" and t in torch_dequant.DEQUANT:
        x = torch_dequant.dequantize(torch.from_numpy(raw.copy()).to(out.device), t, (r1 - r0) * k)
        out[r0:r1].copy_(x.reshape(r1 - r0, k))
        return
    x = dequantize(raw, t, (r1 - r0) * k).reshape(r1 - r0, k)
    out[r0:r1].copy_(torch.from_numpy(x))


def load_params(g: GGUFFile, dtype=torch.float32, keep_quantized: bool = False, device="cuda",
                expert_dtype=None) -> dict:
    """Load GGUF tensors onto `device`.

    keep_quantized=False: every tensor dequantized to `dtype` (what training
    loads).  keep_quantized=True: 2-D quantized matmul weights are repacked to
    planes (quant/planar.py) and stay packed in device memory, consumed by the
    fused kernels; the token embedding is additionally kept dense for the row
    gather.  Every type of planar_types() repacks: Q4_0, Q4_1, Q2_K, Q3_K,
    Q4_K (packed nibbles where (K/2) % G == 0, else int8), Q5_0, Q5_1, Q8_0,
    Q5_K, Q6_K and the IQ* and TQ* types (int8).  A quantized type without
    planes, and every tensor of more than two dims (the stacked experts of a
    mixture-of-experts file), is dequantized to `dtype`, as the JAX loader
    does, and one without a dequantizer raises NotImplementedError.
    expert_dtype: the type of the tensors of more than two dims instead
    (opt/finetune.moe_expert_dtype: the frozen experts of a LoRA base on the
    card); None: `dtype`.

    The tensors are dequantized or repacked in numpy on up to 8 threads (numpy
    releases the interpreter lock in the array work): a 6B model's Q4_K file
    takes minutes on one core.  A tensor of more than _CHUNK_ROWS rows is
    dequantized in chunks, a job each, into its tensor on `device`: chunks of
    rows of a 2-D tensor (the embedding or head of a 128256-entry vocabulary
    would otherwise hold one thread for half a minute) and of whole experts
    of a 3-D one (Qwen3-30B-A3B's stacks hold 201M values each); planes of
    such a tensor are repacked in chunks of rows as well (whole padding
    units, quant/planar.repack_rows), a job each, and put side by side on
    `device` (concat_columns).  No job holds more than its chunk in host
    memory.  On a CUDA device the stacked experts of Q4_K, Q5_0 and Q8_0
    blocks are decoded on the card from their raw bytes (_dequantize_rows),
    bit for bit the host's values.  Each tensor's result does not depend on the order, and the dict
    keeps the file's order.
    """
    from ..quant.planar import concat_columns, padding_unit, planar_types, repack, repack_rows

    def planes(pool, name, info):
        """A future of the planes on `device`, or (combine, futures) of
        chunks of rows (whole padding units) repacked a job each."""
        n, k = (int(d) for d in info.shape)
        t = GGMLType(info.ggml_type)
        if n <= _CHUNK_ROWS:
            return pool.submit(lambda: repack(g.tensor_bytes(name), t, (n, k)).to(device))
        unit = padding_unit(n)
        step = max(unit, _CHUNK_ROWS // unit * unit)
        part = lambda r0: repack_rows(g.tensor_bytes(name), t, (n, k), r0, min(r0 + step, n)).to(device)
        return concat_columns, [pool.submit(part, r) for r in range(0, n, step)]

    def dense(pool, name, info):
        """A future of the tensor on `device`, or (combine, futures) of the
        chunks that fill it."""
        shape = tuple(int(d) for d in info.shape)
        dt = expert_dtype if expert_dtype is not None and len(shape) > 2 else dtype
        n_rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) >= 2 else 1
        if n_rows <= _CHUNK_ROWS and not (torch.device(device).type == "cuda" and len(shape) > 2):
            return pool.submit(lambda: torch.from_numpy(g.to_float32(name)).to(device, dt))
        unit = int(np.prod(shape[1:-1], dtype=np.int64))  # rows an expert holds (1 in a 2-D tensor)
        step = max(1, _CHUNK_ROWS // unit) * unit
        out = torch.empty(shape, dtype=dt, device=device)
        rows = out.view(n_rows, shape[-1])
        return (lambda _: out), [pool.submit(_dequantize_rows, g, name, rows, r, min(r + step, n_rows))
                                 for r in range(0, n_rows, step)]

    def result(job):
        if not isinstance(job, tuple):
            return job.result()
        combine, chunks = job
        return combine([c.result() for c in chunks])

    jobs = []  # (key, job) in the file's order
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for name, info in g.tensors.items():
            is_matmul_weight = (
                name.endswith(".weight")
                and len(info.shape) == 2
                and "norm" not in name
                and name != "position_embd.weight"
            )
            if keep_quantized and is_matmul_weight and GGMLType(info.ggml_type) in planar_types():
                jobs.append((name, planes(pool, name, info)))
                if name == "token_embd.weight":  # dense copy for the row gather
                    jobs.append(("token_embd.weight@dense", dense(pool, name, info)))
            else:
                jobs.append((name, dense(pool, name, info)))
        params: dict[str, Any] = {key: result(job) for key, job in jobs}
    return params


def init_random_params(cfg: GPT2Config, seed: int = 0, dtype=torch.float32, device="cuda") -> dict:
    """Random weights in the converter's naming scheme: the JAX package's
    numpy draws, in the same order, moved to `device` as `dtype`."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.02):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(device, dtype)

    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    E = cfg.n_embd
    p = {
        "token_embd.weight": t(cfg.n_vocab, E),
        "position_embd.weight": t(cfg.n_ctx, E),
        "output_norm.weight": ones(E),
        "output_norm.bias": zeros(E),
    }
    for i in range(cfg.n_layer):
        pre = f"blk.{i}."
        p[pre + "attn_norm.weight"] = ones(E)
        p[pre + "attn_norm.bias"] = zeros(E)
        p[pre + "attn_qkv.weight"] = t(3 * E, E)
        p[pre + "attn_qkv.bias"] = zeros(3 * E)
        p[pre + "attn_output.weight"] = t(E, E)
        p[pre + "attn_output.bias"] = zeros(E)
        p[pre + "ffn_norm.weight"] = ones(E)
        p[pre + "ffn_norm.bias"] = zeros(E)
        p[pre + "ffn_up.weight"] = t(4 * E, E)
        p[pre + "ffn_up.bias"] = zeros(4 * E)
        p[pre + "ffn_down.weight"] = t(E, 4 * E)
        p[pre + "ffn_down.bias"] = zeros(E)
    return p


def init_cache(cfg: GPT2Config, batch: int, max_seq: int, dtype=torch.float32, device="cuda"):
    """KV cache: per layer (k, v), each (batch, n_head, max_seq, head_dim)."""
    return init_layer_cache(cfg.n_layer, batch, cfg.n_head, max_seq, cfg.head_dim, dtype, device)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(0.79788456080286535588 * x * (1.0 + 0.044715 * x * x)))


def _gelu_fp16(x):
    """The reference CPU backend's gelu: out = fp16(gelu(fp16(x)))."""
    xh = x.to(torch.float16).to(torch.float32)
    return _gelu(xh).to(torch.float16).to(x.dtype)


def forward(params: dict, cfg: GPT2Config, tokens: torch.Tensor, pos_start: torch.Tensor, cache,
            cache_len: torch.Tensor, *, prefill: bool = False, train_flash: bool = False,
            need_logits: bool = True, layer_remat=None):
    """One step over tokens (b, t): returns (logits (b, t, n_vocab), cache).

    pos_start (b,) and cache_len are integer tensors on the model's device,
    cache_len 0-d (the whole batch at one position) or (b,) (a position per
    row: the serving engine's step); the cache is written in place.
    need_logits=False skips the final norm and the head: (None, cache).
    prefill is accepted for signature parity with the other families
    (attention always reads the cache window here).  train_flash=True
    (training from an empty cache, t > 1): attention runs through
    flash_attention_train and the cache is neither read nor written; it may
    be None then.  layer_remat: each layer rematerialized
    (common.run_layers)."""
    b, t = tokens.shape
    flash = train_flash and t > 1
    positions = pos_start[:, None] + torch.arange(t, device=tokens.device)[None, :]
    embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
    x = embd[tokens] + params["position_embd.weight"][positions]

    scale = 1.0 / np.sqrt(cfg.head_dim)
    if flash:  # every layer reads the same mask: its tile ranges once per forward
        from ..kernels.flash_attn import flash_attention_train, mask_ranges

        mask = causal_mask(t, x.device)
        ranges = mask_ranges(mask)
    else:
        max_seq = cache[0][0].shape[-2]
        rows = cache_rows(cache_len, t, max_seq)  # cache rows written
        kv_pos = torch.arange(max_seq, device=x.device)[None, None, None, :]
        visible = kv_pos <= positions[:, None, :, None]
    def layer(i, x):
        pre = f"blk.{i}."
        h = _layer_norm(x, params[pre + "attn_norm.weight"], params[pre + "attn_norm.bias"], cfg.eps)
        qkv = _linear(h, params[pre + "attn_qkv.weight"], params[pre + "attn_qkv.bias"])
        q, k, v = torch.split(qkv, cfg.n_embd, dim=-1)

        def heads(z):
            return z.reshape(b, t, cfg.n_head, cfg.head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)  # (b, h, t, d)
        if flash:
            out = flash_attention_train(q, k, v, mask=mask, scale=scale, ranges=ranges)  # (b, t, h, d)
            out = out.reshape(b, t, cfg.n_embd).to(x.dtype)
        else:
            kc, vc = cache[i]
            cache_write(kc, k, cache_len, rows)
            cache_write(vc, v, cache_len, rows)
            # attention over the full cache with the causal and length mask
            att = torch.matmul(q.float(), kc.float().transpose(-1, -2)) * scale
            att = torch.where(visible, att, torch.full((), float("-inf"), device=x.device))
            att = torch.softmax(att, dim=-1).to(vc.dtype)
            out = torch.matmul(att, vc)
            out = out.transpose(1, 2).reshape(b, t, cfg.n_embd).to(x.dtype)
        x = x + _linear(out, params[pre + "attn_output.weight"], params[pre + "attn_output.bias"])

        h = _layer_norm(x, params[pre + "ffn_norm.weight"], params[pre + "ffn_norm.bias"], cfg.eps)
        gelu = _gelu_fp16 if cfg.gelu_fp16 else _gelu
        h = gelu(_linear(h, params[pre + "ffn_up.weight"], params[pre + "ffn_up.bias"]))
        return x + _linear(h, params[pre + "ffn_down.weight"], params[pre + "ffn_down.bias"])

    x = run_layers(layer, cfg.n_layer, x, layer_remat)
    if not need_logits:
        return None, cache
    x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
    return _linear(x, params["token_embd.weight"]), cache  # tied lm head


class GPT2:
    """Inference wrapper: prefill, single decode steps, greedy generation."""

    def __init__(self, params: dict, cfg: GPT2Config, max_seq: int = 512, batch: int = 1, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.batch = batch
        self.device = torch.device(device)
        self.decode_graphs: dict = {}  # cache dtype -> common.DecodeGraph, made at the first graphed decode

    @classmethod
    def from_gguf(cls, path, dtype=torch.float32, keep_quantized: bool = False, device="cuda", **kw):
        with GGUFFile(path) as g:
            cfg = config_from_gguf(g)
            params = load_params(g, dtype, keep_quantized=keep_quantized, device=device)
        return cls(params, cfg, device=device, **kw)

    def new_cache(self, dtype=torch.float32):
        return init_cache(self.cfg, self.batch, self.max_seq, dtype, self.device)

    def _check_room(self, n_past: int, n_new: int):
        if n_past + n_new > self.max_seq:
            raise ValueError(f"{n_past} + {n_new} tokens exceed the cache of {self.max_seq}")

    def prefill(self, cache, tokens: np.ndarray):
        """tokens (b, t) from an empty cache: returns (last-position logits
        (b, n_vocab), cache, t)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(self.device)
        t = tokens.shape[1]
        self._check_room(0, t)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        logits, cache = forward(self.params, self.cfg, tokens, zero.expand(tokens.shape[0]), cache, zero)
        return logits[:, -1, :], cache, t

    def decode_logits(self, cache, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Logits (b, n_vocab) of tokens (b, 1) at position pos, a 0-d int32
        tensor on the model's device; their cache rows are written in place."""
        return forward(self.params, self.cfg, tokens, pos.expand(tokens.shape[0]), cache, pos)[0][:, -1, :]

    def decode_step(self, cache, token, n_past: int):
        """token (b, 1): returns (logits (b, n_vocab), cache)."""
        self._check_room(n_past, 1)
        token = torch.as_tensor(token).to(self.device, torch.long).reshape(-1, 1)
        return self.decode_logits(cache, token, torch.full((), n_past, dtype=torch.int32, device=self.device)), cache

    def decode_greedy(self, cache, first_token, n_past: int, n_tokens: int, graph=None):
        """n_tokens greedy steps from first_token at position n_past, as one
        CUDA graph replay a token on the card (graph=False: eagerly; see
        common.decode_loop).  Returns (cache, ids (n_tokens, b) numpy)."""
        return decode_loop(self, cache, first_token, n_past, n_tokens, graph=graph)

    def generate(self, prompt_tokens: np.ndarray, n_tokens: int, sampler=None, key=None) -> list[int]:
        from .common import generate

        return generate(self, prompt_tokens, n_tokens, sampler=sampler, key=key)
