"""Shared model plumbing: the KV cache, layer norm, linear layers, the
generation loop and the on-device decode loop, greedy or sampled, eager or
replayed as a CUDA graph (port of ggml_tpu/models/common.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..sampling import greedy, sample_top_k_top_p


class QuantKV:
    """The int8-quantized KV cache buffer: codes (B, H, S, D) int8 and one f32
    scale per (B, H, S) row (B, H, S, 1), the llama.cpp `-ctk q8_0` analog
    (ggml_tpu/models/common.py QuantKV).  It answers the few tensor calls the
    forwards and the engine make on a cache buffer (shape, dtype, device,
    nbytes, slicing the leading three axes, copy_, index_copy_, to) over both
    leaves; `dtype` is the type rows are cast to before they are quantized
    (bf16, as in JAX)."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor):
        self.codes = codes
        self.scales = scales

    @property
    def shape(self):
        return self.codes.shape

    @property
    def dtype(self):
        return torch.bfloat16

    @property
    def device(self):
        return self.codes.device

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes + self.scales.nbytes

    def dequant(self) -> torch.Tensor:
        """The dense bf16 view: codes times scales, both in bf16 (as JAX's)."""
        return self.codes.to(torch.bfloat16) * self.scales.to(torch.bfloat16)

    def __getitem__(self, idx):
        return QuantKV(self.codes[idx], self.scales[idx])

    def copy_(self, other: "QuantKV"):
        self.codes.copy_(other.codes)
        self.scales.copy_(other.scales)
        return self

    def index_copy_(self, dim: int, index: torch.Tensor, other: "QuantKV"):
        self.codes.index_copy_(dim, index, other.codes)
        self.scales.index_copy_(dim, index, other.scales)
        return self

    def to(self, *args, **kw) -> "QuantKV":
        """Moves both leaves (a device argument); their types stay."""
        return QuantKV(self.codes.to(*args, **kw), self.scales.to(*args, **kw))


QUANT_KV_DTYPE = "q8_kv"  # pass as the cache dtype to quantize the KV cache


def _quantize_rows(kv: torch.Tensor):
    """kv (b, h, t, d) -> (int8 codes, (b, h, t, 1) f32 scales): scale =
    amax / 127, codes round(kv / max(scale, 1e-12)) half to even (JAX's
    _quantize_rows).  The division is by a tensor: on the card PyTorch turns
    a division by a number into a multiply by its reciprocal."""
    kf = kv.float()
    amax = kf.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.round(kf / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return codes, scale


def dequant_cache(c):
    """The dense view of a cache buffer: a QuantKV as bf16, a tensor as it is."""
    return c.dequant() if isinstance(c, QuantKV) else c


def init_layer_cache(n_layer: int, batch: int, n_kv_head: int, max_seq: int, head_dim: int,
                     dtype=torch.bfloat16, device="cuda") -> list:
    """KV cache as a list of per-layer (k, v) pairs, each (B, H, S, D).

    Where the JAX package donates the cache to its jitted step so that XLA
    updates it in place, the port writes the rows in place itself
    (cache_write); the buffers are allocated once per sequence.
    dtype=QUANT_KV_DTYPE ("q8_kv") stores int8 codes and per-row scales
    (QuantKV) in place of a dense buffer."""
    if dtype == QUANT_KV_DTYPE:
        mk = lambda: QuantKV(torch.zeros((batch, n_kv_head, max_seq, head_dim), dtype=torch.int8, device=device),
                             torch.zeros((batch, n_kv_head, max_seq, 1), dtype=torch.float32, device=device))
        return [(mk(), mk()) for _ in range(n_layer)]
    mk = lambda: torch.zeros((batch, n_kv_head, max_seq, head_dim), dtype=dtype, device=device)
    return [(mk(), mk()) for _ in range(n_layer)]


def cache_leaf(cache) -> torch.Tensor:
    """The first K buffer: it carries the cache's dtype, shape and device."""
    return cache[0][0]


def cache_slot(cache, i: int, width: int = 1) -> list:
    """Views of slots [i, i + width) of every layer's buffers (the batch axis):
    the per-slot view of continuous batching."""
    return [(k[i:i + width], v[i:i + width]) for k, v in cache]


def cache_set_slot(cache, slot_cache, i: int):
    """Copy slot_cache (w, h, S', d) per buffer into slots [i, i + w) of cache,
    rows [0, S') (S' <= S: a shorter slot cache fills the first rows), IN
    PLACE; returns cache, which the JAX cache_set_slot returns anew.  A host
    slot cache (a preemption snapshot) is copied to the card here."""
    for big, small in zip(cache, slot_cache):
        for b, s in zip(big, small):
            b[i:i + s.shape[0], :, :s.shape[2]].copy_(s)
    return cache


def cache_rows(cache_len: torch.Tensor, t: int, max_seq: int) -> torch.Tensor:
    """The cache rows that t new tokens at cache_len write, as a long tensor
    on cache_len's device: (t,) for a 0-d position shared by the batch, (b, t)
    for a (b,) vector of per-row positions (continuous batching).  The start
    is clamped to [0, max_seq - t], as JAX's dynamic_update_slice clamps it,
    so no write leaves the cache (an index past S would raise a device-side
    assert in PyTorch).  Computed once per forward, reading no host value."""
    start = cache_len.to(torch.long).clamp(0, max_seq - t)
    ar = torch.arange(t, device=cache_len.device)
    return start + ar if start.dim() == 0 else start[:, None] + ar[None, :]


def cache_write(cache_layer: torch.Tensor, kv: torch.Tensor, cache_len: torch.Tensor,
                rows: torch.Tensor | None = None):
    """Write kv (b, h, t, d) into cache_layer (b, h, S, d) IN PLACE at
    position cache_len: 0-d (every sequence of the batch at one position) or
    (b,) (one position per row, the JAX vmapped dynamic_update_slice).  rows:
    cache_rows(cache_len, t, S), which a forward computes once for all its
    layers.  Nothing is read on the host, so a CUDA graph captures the write.
    A QuantKV buffer quantizes the rows (cast to bf16 first, as the JAX
    forwards cast them to the cache's dtype) and writes codes and scales."""
    if rows is None:
        rows = cache_rows(cache_len, kv.shape[2], cache_layer.shape[2])
    kv = kv.to(cache_layer.dtype)
    if isinstance(cache_layer, QuantKV):
        codes, scales = _quantize_rows(kv)
        cache_write(cache_layer.codes, codes, cache_len, rows)
        cache_write(cache_layer.scales, scales, cache_len, rows)
        return
    if rows.dim() == 1:
        cache_layer.index_copy_(2, rows, kv)
    else:
        cache_layer.scatter_(2, rows[:, None, :, None].expand(kv.shape), kv)


@functools.lru_cache(maxsize=4)
def causal_mask(t: int, device="cuda") -> torch.Tensor:
    """Additive (t, t) f32 causal mask with a finite -inf (-1e30 above the
    diagonal), built on the device and cached per length and device.  Only
    the last few lengths are kept: at t = 2048 a mask is 16.8 MB."""
    i = torch.arange(t, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, -1e30).to(torch.float32)


def layer_norm(x, w, b, eps):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean((x - m) ** 2, dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w + b


class LoRAWeight:
    """A weight with a low-rank adapter riding it: W_eff = base + scale·B@A
    (port of ggml_tpu/models/common.py LoRAWeight).

    The QLoRA shape: `base` stays a PlanarWeight (frozen planes on the card,
    read by the fused kernels; gradients reach the activations through
    planar_matmul's backward) while `a` (r, k) and `b` (n, r) are small dense
    trainables.  linear() applies the adapter as (x @ Aᵀ) @ Bᵀ, rank-r
    products that never form B@A.  Works over dense bases too."""

    def __init__(self, base, a, b, scale: float = 1.0):
        self.base = base
        self.a = a
        self.b = b
        self.scale = scale

    @property
    def shape(self):  # ggml orientation (N, K)
        return (self.b.shape[0], self.a.shape[1])

    @property
    def ndim(self):
        return 2


def linear(x, w, b=None):
    """Dense, planar-quantized or LoRA-adapted matmul: y = x @ W^T (+ b).  A
    dense f32 product runs in full f32: the caller keeps TF32 off, as the JAX
    package pins Precision.HIGHEST.  x and a dense W of two types meet in
    the promoted type, as in the JAX einsum (a LoRA adapter merged into
    one weight of a bf16 model makes that weight f32)."""
    from ..quant.planar import PlanarWeight

    if isinstance(w, LoRAWeight):
        out = linear(x, w.base)
        lo = torch.matmul(x, w.a.to(x.dtype).t())
        out = out + w.scale * torch.matmul(lo, w.b.to(x.dtype).t())
    elif isinstance(w, PlanarWeight):
        from ..kernels.qmatmul import planar_matmul

        out = planar_matmul(x, w)
    else:
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        out = torch.matmul(x, w.t())
    if b is not None:
        out = out + b
    return out


def run_layers(layer, n_layer: int, x, remat=None):
    """x through layer(i, x) for i in range(n_layer): the layer loop of the
    family forwards.  remat(layer, i, x), where a training forward hands one
    (opt.finetune._remat), runs a layer rematerialized: its backward runs
    its forward again just before it, so one layer's recomputed activations
    are alive at a time."""
    for i in range(n_layer):
        x = layer(i, x) if remat is None else remat(layer, i, x)
    return x


def generate(model, prompt_tokens: np.ndarray, n_tokens: int, sampler=None, key=None) -> list[int]:
    """Generation shared by the model wrappers: prefill, then greedy decode
    through model.decode_greedy (the on-device loop), or, with a sampler,
    the host loop of the JAX generate: sampler(logits (b, n_vocab), key) ->
    (tokens (b,), key), e.g. lambda l, g: sample_top_k_top_p(l, g) with key
    a torch.Generator on the model's device, then one decode step per token
    (none after the last).  Returns the n_tokens generated ids of the first
    sequence, as the JAX generate does."""
    cache = model.new_cache()
    logits, cache, n_past = model.prefill(cache, prompt_tokens)
    if sampler is None:
        first = torch.argmax(logits, dim=-1, keepdim=True)
        if n_tokens <= 1:
            return first[0, :n_tokens].tolist()
        cache, toks = model.decode_greedy(cache, first, n_past, n_tokens - 1)
        return [int(first[0, 0])] + toks[:, 0].tolist()
    out = []
    for i in range(n_tokens):
        tok, key = sampler(logits, key)
        out.append(int(tok[0]))
        if i + 1 < n_tokens:
            logits, cache = model.decode_step(cache, tok.reshape(-1, 1), n_past)
            n_past += 1
    return out


def launch_tables() -> list[dict]:
    """The kernel modules' launch counters (each wrapper adds one where it
    launches its kernel; a decode graph adds its step's once per replay)."""
    from ..kernels import decode_attn, flash_attn, qmatmul

    return [qmatmul.launches, decode_attn.launches, flash_attn.launches]


class _DecodeState:
    """The decode loop's carry on the device (the JAX scan's carry, less the
    cache): the token fed next (b, 1), its position (0-d int32, which the
    decode attention kernel reads itself), the step index (1,) and the ids
    written so far (n, b)."""

    def __init__(self, batch: int, n: int, device):
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)
        self.step = torch.zeros((1,), dtype=torch.long, device=device)
        self.out = torch.zeros((n, batch), dtype=torch.long, device=device)

    def start(self, first_token, n_past: int):
        self.tok.copy_(torch.as_tensor(first_token).reshape(self.tok.shape))
        self.pos.fill_(n_past)
        self.step.zero_()


def _decode_step(model, state: _DecodeState, cache, pick):
    """One step of the decode loop, reading no value on the host: the logits
    of state.tok at state.pos (its cache row written), the next token by
    pick(logits) into out[step] and tok; then pos and step advance."""
    nxt = pick(model.decode_logits(cache, state.tok, state.pos))
    state.out.index_copy_(0, state.step, nxt.view(1, -1))
    state.tok.copy_(nxt.view(-1, 1))
    state.pos += 1
    state.step += 1


def _sampler(generator, temperature, top_k: int, top_p):
    return lambda logits: sample_top_k_top_p(logits, generator, temperature, top_k, top_p)[0]


class DecodeGraph:
    """The port of the jitted lax.scan decode loop: one decode step captured
    as a CUDA graph and replayed once per token, so the host makes one graph
    launch a token instead of the step's kernel launches.

    A graph binds addresses, so its step runs over buffers this object owns:
    the carry and a cache of the model's batch, max_seq and `cache_dtype`.
    A request copies its cache rows [0, n_past) in and the rows it decodes
    back out (the step never reads a row past its position before writing
    it), and later requests replay the same graphs: one for greedy decode and
    one per top_k for sampled decode, whose temperature and top_p are device
    scalars here and whose draws come from a generator registered with the
    graph, set to the request's generator's state before the replays and
    copied back after.  The kernels' launch counters do not move during a
    replay: each graph keeps what its captured step added to them and adds
    that once per replay.  A capture that fails raises."""

    def __init__(self, model, cache_dtype):
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a model on the card, not on {model.device}")
        dev = model.device
        self.model = model
        self.cache = model.new_cache(cache_dtype)
        self.state = _DecodeState(model.batch, model.max_seq, dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.top_p = torch.ones((), dtype=torch.float32, device=dev)
        self.generator = torch.Generator(device=dev)
        self.graphs: dict = {}  # None (greedy) or top_k -> (CUDAGraph, launches of one step per table)
        self.captures = 0

    def _capture(self, top_k):
        graph = torch.cuda.CUDAGraph()
        pick = greedy
        if top_k is not None:
            if not hasattr(graph, "register_generator_state"):
                raise NotImplementedError(f"torch {torch.__version__} cannot register a generator with a CUDA "
                                          "graph: sampled decode cannot be graphed")
            graph.register_generator_state(self.generator)
            pick = _sampler(self.generator, self.temperature, top_k, self.top_p)
        step = lambda: _decode_step(self.model, self.state, self.cache, pick)
        # warm-up outside the capture: builds the kernel library and fills
        # every first-use cache (RoPE frequencies, the decode attention's
        # arrival counters, library handles), on a side stream as PyTorch
        # asks; it writes rows 0 and 1 of the static cache, which no request
        # reads before writing them
        self.state.start(torch.zeros_like(self.state.tok), 0)
        side = torch.cuda.Stream(self.model.device)
        side.wait_stream(torch.cuda.current_stream(self.model.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(self.model.device).wait_stream(side)
        tables = launch_tables()
        before = [dict(t) for t in tables]
        with torch.cuda.graph(graph):  # capture_error_mode "global": a forbidden call fails the capture
            step()
        per_step = []
        for table, was in zip(tables, before):  # the capture launched nothing: its counts move to the replays
            per_step.append({k: table[k] - was[k] for k in table})
            table.update(was)
        self.captures += 1
        return graph, per_step

    def run(self, cache, first_token, n_past: int, n_tokens: int, sampling=None) -> np.ndarray:
        """Decode n_tokens from first_token at position n_past over the
        caller's cache (rows [n_past, n_past + n_tokens) written back);
        sampling: None (greedy) or (generator, temperature, top_k, top_p).
        Returns the ids (n_tokens, b)."""
        if len(cache) != len(self.cache) or any(
                c.shape != s.shape or c.dtype != s.dtype or c.device != s.device
                for layer, static in zip(cache, self.cache) for c, s in zip(layer, static)):
            raise ValueError("the cache does not match the model's (batch, max_seq, dtype, device)")
        top_k = None
        if sampling is not None:
            generator, temperature, top_k, top_p = sampling
            if generator.device != self.generator.device:
                raise ValueError(f"the generator is on {generator.device}, the model on {self.generator.device}")
        entry = self.graphs.get(top_k)
        if entry is None:
            entry = self.graphs[top_k] = self._capture(top_k)
        graph, per_step = entry
        for layer, static in zip(cache, self.cache):
            for c, s in zip(layer, static):
                s[:, :, :n_past].copy_(c[:, :, :n_past])
        self.state.start(first_token, n_past)
        if sampling is not None:
            self.temperature.fill_(temperature)
            self.top_p.fill_(top_p)
            self.generator.set_state(generator.get_state())
        for _ in range(n_tokens):
            graph.replay()
        if sampling is not None:
            generator.set_state(self.generator.get_state())
        for table, counts in zip(launch_tables(), per_step):
            for k, n in counts.items():
                table[k] += n * n_tokens
        rows = slice(n_past, n_past + n_tokens)
        for layer, static in zip(cache, self.cache):
            for c, s in zip(layer, static):
                c[:, :, rows].copy_(s[:, :, rows])
        return self.state.out[:n_tokens].cpu().numpy()


def decode_loop(model, cache, first_token, n_past: int, n_tokens: int, *, graph=None, sampling=None):
    """The on-device decode loop of the model wrappers (the JAX
    decode_loop / make_sampled_decode scan): n_tokens steps from first_token
    (b, 1) at position n_past, each token chosen on the device, greedy or,
    with sampling = (generator, temperature, top_k, top_p), drawn by
    sample_top_k_top_p.  graph: replay a captured step (DecodeGraph, one per
    cache dtype on the model, kept in model.decode_graphs); the default on
    the card, and True on a CPU model raises.  graph=False steps eagerly over
    the caller's cache.  The host waits only for the returned ids.  Returns
    (cache, ids (n_tokens, b) numpy)."""
    model._check_room(n_past, n_tokens)
    if graph is None:
        graph = model.device.type == "cuda"
    if graph:
        dtype = cache[0][0].dtype
        if dtype not in model.decode_graphs:
            model.decode_graphs[dtype] = DecodeGraph(model, dtype)
        return cache, model.decode_graphs[dtype].run(cache, first_token, n_past, n_tokens, sampling)
    state = _DecodeState(model.batch, n_tokens, model.device)
    state.start(first_token, n_past)
    pick = greedy
    if sampling is not None:
        generator, temperature, top_k, top_p = sampling
        scalar = lambda x: torch.as_tensor(x, dtype=torch.float32, device=model.device)
        pick = _sampler(generator, scalar(temperature), top_k, scalar(top_p))
    for _ in range(n_tokens):
        _decode_step(model, state, cache, pick)
    return cache, state.out.cpu().numpy()


def make_sampled_decode(model):
    """The on-device sampled decode loop (top-k/top-p/temperature inside the
    loop, the draws from a torch.Generator on the model's device: the JAX
    scan with its PRNG key in the carry), graphed on the card: one graph per
    top_k.  Returns decode_sampled(cache, first_token, n_past, n_tokens,
    generator, temperature=0.8, top_k=40, top_p=0.95, graph=None) ->
    (cache, ids (n_tokens, b))."""

    def decode_sampled(cache, first_token, n_past, n_tokens, generator, temperature=0.8, top_k=40, top_p=0.95,
                       graph=None):
        return decode_loop(model, cache, first_token, n_past, n_tokens, graph=graph,
                           sampling=(generator, float(temperature), int(top_k), float(top_p)))

    return decode_sampled
