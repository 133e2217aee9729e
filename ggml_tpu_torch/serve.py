"""Continuous-batching generation engine: the serving control plane (port of
ggml_tpu/serve.py; reference analog: the seq-id KV cache of
examples/gpt-2/main-batched.cpp:41-145).

A fixed pool of max_batch KV-cache slots in ONE static cache that the engine
owns and writes in place (where the JAX engine donates its cache to XLA);
per-slot positions (the families' forward with a (b,) cache_len); admission
when slots free up, one batched prefill per prompt bucket; greedy, sampled
with the engine's sampler, or per-request temperature and top_p, all chosen
on the device.  The decode step runs h steps a tick over static (token,
position, alive, budget, temperature, top_p) buffers with the EOS, budget
and window stops applied on the device (JAX's jitted step_scan); on the card
those h steps are ONE CUDA graph replay (one capture per (h, sampled)), and
run()'s pipelined stretch enqueues tick t+1 before it reads tick t's tokens,
which reach the host through pinned memory behind an event.

The other paths of the JAX engine that the port has:
- paged KV (paged=PagedConfig): a shared page pool (paged_kv.py) in place of
  the dense cache, with the prefix cache (prompts that share page-aligned
  prefixes prefill only their suffix), eviction under page pressure, and
  greedy stretches of h steps as one CUDA graph replay;
- chunked prefill (prefill_chunk=C): prompts prefill in chunks of C tokens
  over a populated cache, batched as (max_batch, C) dispatches;
- the q8 KV cache (cache_dtype="q8_kv"): int8 codes and per-row scales
  (models/common.QuantKV), dequantized on read;
- speculative decoding (draft=model, draft_k=k): every tick drafts k tokens
  a slot with the draft model over its own dense cache and verifies them in
  ONE (max_batch, k + 1) target forward, greedy or by rejection sampling
  (speculative.py's rules per slot).  Dense engines run SPEC_STRETCH rounds
  a dispatch with the accept rule on the device (one CUDA graph replay on
  the card); paged engines verify through paged_kv.make_paged_verify_step.
  Every admission path mirrors the prompt into the draft's cache.

The engine's invariant (docs/serving.md): every request emits what it would
emit alone.  Batching, admission order and preemption change no id.

Not ported yet (ROADMAP.md): forward_fn and cache_put (tensor-parallel
serving).
"""

from __future__ import annotations

import collections
import contextlib
import os
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .models.common import (QUANT_KV_DTYPE, cache_set_slot, cache_slot, capture_graph, count_replays,
                            init_layer_cache)
from .sampling import sample_top_k_top_p
from .speculative import _forward_for, spec_round

# rounds of a speculative stretch: one dispatch and one read cover R draft
# and verify rounds (the window margin reserves R * (draft_k + 1) rows)
SPEC_STRETCH = 4

@dataclass
class _PrefillShare:
    """Lazily computed shared prefill of forked requests (the shared-prefix
    batching of examples/gpt-2/main-batched.cpp:81-145: one prompt evaluated
    once, its KV cache copied into every fork's slot)."""

    logits: Any = None  # (1, vocab) last-position logits, or None (bucket padding)
    cache: Any = None  # single-slot cache
    t: int = 0
    draft: Any = None  # the draft's single-slot cache (speculative engines)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (t,) int32
    max_new_tokens: int
    out: list = field(default_factory=list)
    done: bool = False
    on_token: Callable | None = None  # streaming callback (rid, token, done)
    priority: int = 0  # lower = more urgent
    preempted: int = 0  # times evicted back to the queue
    # per-request sampling overrides ({"temperature", "top_p"}; top_k is
    # engine-static): temperature == 0 means exact greedy for this request
    sampling: dict | None = None
    share: _PrefillShare | None = None  # forked-generation prefill share
    # device->host KV snapshot taken at eviction: {"cache": host slot cache
    # (rows [0, n_past)), "n_past": int, "cur_tok": int, "draft": the draft's
    # rows [0, n_past) or None}; resume restores it instead of re-prefilling
    # the sequence
    snapshot: dict | None = None

    @property
    def seq(self) -> np.ndarray:
        """Prompt plus generated-so-far: the prefill input on (re)admission."""
        if not self.out:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.out, np.int32)])


def _cache_maker(model, dtype, max_seq: int) -> Callable:
    """make(b, rows=max_seq) -> a dense cache of b slots for the model's
    family on its device: the latent pair of Deepseek's MLA
    (deepseek.init_cache), every other family's (k, v) heads."""
    from .models import deepseek

    cfg, dev = model.cfg, model.device
    if isinstance(model, deepseek.Deepseek):
        return lambda b, rows=max_seq: deepseek.init_cache(cfg, b, rows, dtype, dev)
    n_kv = getattr(cfg, "n_head_kv", cfg.n_head)
    return lambda b, rows=max_seq: init_layer_cache(cfg.n_layer, b, n_kv, rows, cfg.head_dim, dtype, dev)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, section 1: tensor-parallel serving)")


class Engine:
    """model: a Llama, Deepseek, GPTJ, GPT2, GLM4MoE, OlmoE, DBRX, PhiMoE,
    GptOss, Gemma2, Phi2, Phi3, NeoX or Falcon wrapper (params, cfg, device) whose family
    forward(params, cfg, tokens, pos_start, cache, cache_len) takes per-row
    cache_len vectors.  max_batch slots share one cache of max_seq rows.

    sampler: None = greedy argmax; or keyword arguments of
    sampling.sample_top_k_top_p (temperature, top_k, top_p) applied per slot
    on the device with the engine's torch.Generator (seeded by seed, on the
    model's device: the JAX engine's PRNGKey(seed); the two draw different
    streams from the same distribution).  horizon: decode steps a tick
    (default GGML_TPU_TICK_HORIZON or 16), rounded down to a power of two.
    record_events: bracket every tick, prefill, chunk dispatch and paged
    stretch on the card with CUDA events (event_ms() sums them).

    paged: a paged_kv.PagedConfig: KV memory becomes a shared page pool
    (capacity = the sum of live contexts); slots that run out of pages evict
    the least urgent running request back to the queue.  prefill_chunk: C
    tokens a prefill dispatch.  cache_dtype="q8_kv": the int8 KV cache (dense
    engine only).  draft: a model of the same vocabulary on the same device
    (a wrapper over a prefix of the target's own layers shares its tensors):
    every tick drafts draft_k tokens a slot and verifies them in one (B,
    draft_k + 1) target forward; greedy engines emit the plain engine's ids
    wherever the verify's and a step's logits agree on the argmax, sampled
    ones run rejection sampling (a paged engine over a Deepseek target takes
    no draft, as JAX's does not).  Each is checked against
    serving_matrix.features_for.  forward_fn and cache_put raise
    NotImplementedError."""

    def __init__(self, model, max_batch: int = 4, max_seq: int = 512, eos_id: int = -1,
                 cache_dtype=torch.bfloat16, sampler: dict | None = None, seed: int = 0,
                 paged=None, draft=None, draft_k: int = 4,
                 forward_fn=None, cache_put=None, prefill_chunk: int | None = None,
                 horizon: int | None = None, record_events: bool = False):
        from .models import deepseek
        from .serving_matrix import features_for

        try:
            self._fwd = _forward_for(model)
        except TypeError:
            raise TypeError(f"Engine cannot drive {type(model).__name__}") from None
        for flag, what in ((forward_fn is not None, "a custom engine forward (forward_fn=)"),
                           (cache_put is not None, "a placed KV cache (cache_put=)")):
            if flag:
                raise _not_ported(what)
        if not (isinstance(cache_dtype, torch.dtype) or cache_dtype == QUANT_KV_DTYPE):
            raise ValueError(f"cache_dtype {cache_dtype!r}: a torch dtype or {QUANT_KV_DTYPE!r}")
        # feature x family gate (serving_matrix): an unsupported combination
        # fails here with the matrix's answer
        feats = features_for(model)
        for flag, feat in ((paged is not None, "paged_kv"), (draft is not None, "speculative"),
                           (cache_dtype == QUANT_KV_DTYPE, "q8_kv"), (bool(prefill_chunk), "chunked_prefill")):
            if flag and not feats[feat]:
                raise TypeError(f"{type(model).__name__} does not support '{feat}' (serving_matrix.py)")
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = dev = model.device
        self.max_batch = B = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self._make_cache = _cache_maker(model, cache_dtype, max_seq)
        self.tick_horizon = (horizon if horizon is not None
                             else int(os.environ.get("GGML_TPU_TICK_HORIZON", "16")))
        self._hb = 1  # largest power of two <= horizon: one graph per sampling mode
        while self._hb * 2 <= self.tick_horizon:
            self._hb *= 2
        self.paged = paged
        self.mgr = None
        if paged is not None:
            from .paged_kv import PagedKVManager, make_paged_decode_scan, make_paged_decode_step

            if cache_dtype == QUANT_KV_DTYPE:
                raise ValueError("the q8 KV cache is dense-engine only (the page pools keep their own dtype)")
            if paged.page_size * paged.max_pages_per_seq < max_seq:
                raise ValueError("paged logical window smaller than max_seq")
            if isinstance(model, deepseek.Deepseek):  # the MLA pools: the latent and the rope key, one head
                self.mgr = PagedKVManager(cfg.n_layer, 1, (cfg.kv_lora_rank, cfg.qk_rope_dim), B, paged, cache_dtype,
                                          dev)
            else:
                self.mgr = PagedKVManager(cfg.n_layer, getattr(cfg, "n_head_kv", cfg.n_head), cfg.head_dim, B, paged,
                                          cache_dtype, dev)
            self._paged_step = make_paged_decode_step(model, paged, forward_fn=self._fwd)
            self._paged_scan = make_paged_decode_scan(self._paged_step, B, paged.max_pages_per_seq, self._hb, dev)
            self.cache = None
        else:
            # the engine's one cache: never rebound; prefills and restores
            # copy into it, steps write their rows in place
            self.cache = self._make_cache(B)
        self.prefill_chunk = prefill_chunk
        self._chunk_cache = None  # the (max_batch, max_seq) cache of chunked waves: made once, reused
        self.chunk_dispatches = 0
        self.cached_prefix_tokens = 0  # prefix-cache observability

        self.sampler = dict(sampler) if sampler else None
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        scalar = lambda x: torch.tensor(float(x), dtype=torch.float32, device=dev)
        # the engine sampler's floats as device scalars: a captured graph
        # reads them, and a Python float would be copied to the card inside it
        self._sampler_kw = None if self.sampler is None else {
            k: (scalar(v) if k in ("temperature", "top_p") else v) for k, v in self.sampler.items()}
        # per-request sampling (the server path): slot-vector temperature and
        # top_p with an engine-static top_k; temperature 0 is exact greedy.
        # Switched on by the first submit(sampling=...)
        base = self.sampler or {}
        self._default_temp = float(base.get("temperature", 1.0)) if self.sampler else 0.0
        self._default_topp = float(base.get("top_p", 0.9)) if self.sampler else 1.0
        self._slot_top_k = int(base.get("top_k", 40))
        self._slot_temp = np.full(B, self._default_temp, np.float32)
        self._slot_topp = np.full(B, self._default_topp, np.float32)
        self._any_slot_sampling = False

        # the decode state on the device: static buffers a captured graph
        # reads and writes; the host writes them with copy_ and index_copy_
        # only, never rebinding them
        self._tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self._np = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._alive = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._budget = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._temp = torch.ones((B, 1), dtype=torch.float32, device=dev)
        self._topp = torch.ones((B, 1), dtype=torch.float32, device=dev)
        self._outs = torch.zeros((self._hb, B), dtype=torch.long, device=dev)
        self._graphs: dict = {}  # (h, sampled) -> (CUDAGraph, launches of its h steps per table)
        self.captures = 0
        self.replays = 0
        self.decode_steps = 0  # forward steps run: eagerly, warming a capture up, or h per replay
        self.record_events = record_events
        self.events: list = []  # (kind, start, end) CUDA events, with record_events

        self.draft = draft
        self.draft_k = draft_k
        self._pending_draft = None  # a per-request admission's draft slot cache, until _admit installs it
        if draft is not None:
            self._init_draft(draft, draft_k, cache_dtype)

        self.slots: list[Request | None] = [None] * B
        self.n_past = np.zeros(B, np.int32)
        self.cur_tok = np.zeros(B, np.int32)
        self.queue: collections.deque[Request] = collections.deque()
        self._rid = 0
        self.prefill_count = 0  # observability (and the shared-prefill tests)

    # -- public API -------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, on_token=None, priority: int = 0,
               sampling: dict | None = None) -> int:
        """on_token: optional streaming callback (rid, token, done) invoked as
        each token is produced.  priority: lower is more urgent; when all
        slots are busy, an arriving more urgent request preempts the least
        urgent running one (its KV is spilled to the host and restored on
        resume).  sampling: per-request {"temperature", "top_p"} overrides
        (top_k is engine-static); temperature == 0 -> exact greedy."""
        prompt = self._check_prompt(prompt)
        if sampling is not None:
            self._check_slot_sampling()
            bad = set(sampling) - {"temperature", "top_p"}
            if bad:
                raise ValueError(f"unknown sampling keys: {sorted(bad)}")
            self._any_slot_sampling = True
        self._rid += 1
        self.queue.append(Request(self._rid, prompt, max_new_tokens, on_token=on_token, priority=priority,
                                  sampling=sampling))
        return self._rid

    def submit_many(self, prompt, n: int, max_new_tokens: int, on_token=None, priority: int = 0,
                    sampling: dict | None = None) -> list[int]:
        """Fork n sampled continuations of ONE prompt: the prompt is prefilled
        once and its KV cache copied into every fork's slot (the shared-prefix
        batching of main-batched.cpp:81-145).  sampling: as in submit()."""
        prompt = self._check_prompt(prompt)
        if sampling is not None:
            self._check_slot_sampling()
            self._any_slot_sampling = True
        share = _PrefillShare()
        rids = []
        for _ in range(n):
            self._rid += 1
            self.queue.append(Request(self._rid, prompt, max_new_tokens, on_token=on_token, priority=priority,
                                      share=share, sampling=sampling))
            rids.append(self._rid)
        return rids

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request; its slot frees on the next
        run() sweep.  Returns True if the request was found."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                return True
        for s in self.slots:
            if s is not None and s.rid == rid and not s.done:
                s.done = True
                return True
        return False

    def run(self, bucket: int = 32, abort_callback=None) -> dict[int, list[int]]:
        """Drive to completion; returns {rid: generated token ids}.
        abort_callback: checked per tick, True stops early.  With a horizon
        above 1 the engine decodes in pipelined stretches: tick t+1 is
        enqueued from the device-resident state before tick t's tokens are
        read, and admission rides inside the stretch."""
        results: dict[int, list[int]] = {}
        scan_mode = self.paged is None and self.draft is None and self._hb > 1
        aborted = False
        while (self.queue or any(s is not None for s in self.slots)) and not aborted:
            if abort_callback is not None and abort_callback():
                break
            self._admit(bucket)
            if scan_mode:
                aborted = self._run_scan_stretch(abort_callback, results, bucket)
            else:
                self._tick()
            for i, s in enumerate(self.slots):
                if s is not None and s.done:
                    results[s.rid] = s.out
                    self.slots[i] = None
                    if self.paged is not None:
                        self.mgr.release(i)
        return results

    def event_ms(self) -> dict:
        """Device ms inside the recorded spans by kind ("tick", "prefill",
        "chunk", "paged", "spec"):
        waits for the card, then clears the record."""
        out: dict = {}
        if self.events:
            torch.cuda.synchronize(self.device)
        for kind, start, end in self.events:
            out[kind] = out.get(kind, 0.0) + start.elapsed_time(end)
        self.events.clear()
        return out

    # -- the device step ----------------------------------------------------------

    def _check_slot_sampling(self):
        if self.draft is not None:
            raise ValueError("per-request sampling is not supported in speculative mode (engine-level sampler only)")

    def _check_prompt(self, prompt) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) >= self.max_seq:
            raise ValueError(f"prompt length {len(prompt)} exceeds engine max_seq {self.max_seq}")
        return prompt

    def _put(self, buf: torch.Tensor, values, index: torch.Tensor | None = None):
        """Write host values into a device buffer without a host wait: through
        pinned memory, asynchronously on the card (PyTorch keeps the pinned
        block until the copy has run).  index: write only those rows."""
        src = self._to_device(values, buf.dtype)
        if index is None:
            buf.copy_(src.reshape(buf.shape))
        else:
            buf.index_copy_(0, index, src.reshape((-1,) + buf.shape[1:]))

    def _to_device(self, values, dtype=torch.long) -> torch.Tensor:
        """Host values as a tensor on the model's device, copied from pinned
        memory without a host wait."""
        t = torch.as_tensor(np.asarray(values), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _pick(self, logits, sampled: bool, temp=None, topp=None):
        """(b, vocab) logits -> (b,) ids on the device: per slot (temperature
        and top_p (b, 1), greedy where the temperature is 0), with the
        engine's sampler, or greedy."""
        if sampled:
            temp = self._temp if temp is None else temp
            topp = self._topp if topp is None else topp
            drawn, _ = sample_top_k_top_p(logits, self.generator, temperature=temp,
                                          top_k=min(self._slot_top_k, logits.shape[-1]), top_p=topp)
            return torch.where(temp[:, 0] > 0, drawn, torch.argmax(logits, dim=-1))
        if self._sampler_kw is not None:
            return sample_top_k_top_p(logits, self.generator, **self._sampler_kw)[0]
        return torch.argmax(logits, dim=-1)

    def _steps(self, h: int, sampled: bool):
        """h decode steps over the static buffers (JAX's step_scan): each
        feeds every slot's token at its own position, picks the next, masks
        dead slots' tokens to 0 and applies the EOS, budget and window stops
        on the device.  Dead slots ride along at frozen positions, writing a
        junk row there that no live query reads.  Reads no host value."""
        for j in range(h):
            logits, _ = self._fwd(self.model.params, self.cfg, self._tok, self._np, self.cache, self._np)
            nxt = torch.where(self._alive, self._pick(logits[:, -1, :], sampled), 0)
            self._outs[j].copy_(nxt)
            live = self._alive.to(torch.int32)
            self._np += live
            self._budget -= live
            self._alive &= (nxt != self.eos_id) & (self._budget > 0) & (self._np < self.max_seq - 1)
            self._tok.copy_(nxt[:, None])

    def _capture(self, run: Callable, sampled: bool):
        """Capture run() (h decode steps, or R speculative rounds) as a CUDA
        graph (models/common.capture_graph): its warm-up's state buffers and
        generator restored (its rows at and past each slot's position, in
        the cache and the draft's, are rewritten by the real steps before
        any query reads them)."""
        self.captures += 1
        draws = sampled or self._sampler_kw is not None
        return capture_graph(run, self.device, (self._tok, self._np, self._alive, self._budget),
                             self.generator if draws else None)

    @contextlib.contextmanager
    def _span(self, kind: str):
        if not (self.record_events and self.device.type == "cuda"):
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.append((kind, start, end))

    def _replay(self, key, run: Callable, sampled: bool, span: str):
        """One replay of the graph of run() (captured at its first use, the
        warm-up's steps counted by the caller), its launch counts added."""
        if key not in self._graphs:
            self._graphs[key] = self._capture(run, sampled)
        graph, per_tick = self._graphs[key]
        with self._span(span):
            graph.replay()
        count_replays(per_tick)
        self.replays += 1

    def _dispatch(self, sampled: bool):
        """Enqueue one tick of h steps; returns a handle for _fetch.  On the
        card: one graph replay, its (h, B) ids copied to pinned host memory
        behind an event, nothing waited for."""
        h = self._hb
        with torch.no_grad():
            if self.device.type != "cuda":
                self._steps(h, sampled)
                self.decode_steps += h
                return self._outs[:h].clone(), None
            if (h, sampled) not in self._graphs:
                self.decode_steps += h  # the capture's warm-up
            self._replay((h, sampled), lambda: self._steps(h, sampled), sampled, "tick")
            self.decode_steps += h
            host = torch.empty((h, self.max_batch), dtype=torch.long, pin_memory=True)
            host.copy_(self._outs[:h], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        host, done = handle
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _load_state(self, alive: np.ndarray, budget: np.ndarray):
        """The host's decode state into the device buffers (all slots)."""
        self._put(self._tok, self.cur_tok)
        self._put(self._np, self.n_past)
        self._put(self._alive, alive)
        self._put(self._budget, budget)
        self._put(self._temp, self._slot_temp)
        self._put(self._topp, self._slot_topp)

    # -- speculative decoding ----------------------------------------------------

    def _init_draft(self, draft, k: int, cache_dtype):
        """The draft's family forward, its own dense cache of max_batch x
        max_seq rows, the stop margin (room for k + 1 verify rows inside the
        window, the paged one too), the paged verify step and the stretch's
        output buffers."""
        if draft.device != self.device:
            raise ValueError(f"the draft is on {draft.device}, the model on {self.device}")
        if k < 1:
            raise ValueError(f"draft_k = {k}: at least one draft token a tick")
        from .models import deepseek

        if self.paged is not None and isinstance(self.model, deepseek.Deepseek):
            raise ValueError("speculative + paged KV does not compose for MLA targets (asymmetric latent pools "
                             "need their own verify step), as in the JAX engine")
        self._draft_fwd = _forward_for(draft)
        self._make_draft_cache = _cache_maker(draft, cache_dtype, self.max_seq)
        self.draft_cache = self._make_draft_cache(self.max_batch)  # never rebound, as the cache
        self._spec_margin = self.max_seq - k - 2
        if self.paged is not None:
            from .paged_kv import make_paged_verify_step

            self._spec_margin = min(self._spec_margin, self.paged.max_pages_per_seq * self.paged.page_size - k - 1)
            self._paged_verify = make_paged_verify_step(self.model, self.paged, forward_fn=self._fwd)
            # the paged round's static inputs: the page tables and the k + 1 rows' write coordinates
            B, P = self.max_batch, self.paged.max_pages_per_seq
            self._ptables = torch.zeros((B, P), dtype=torch.long, device=self.device)
            self._pwpages = torch.zeros((B, k + 1), dtype=torch.long, device=self.device)
            self._pwoffs = torch.zeros((B, k + 1), dtype=torch.long, device=self.device)
        self._blocks = torch.zeros((SPEC_STRETCH, self.max_batch, k + 1), dtype=torch.long, device=self.device)
        self._naccs = torch.zeros((SPEC_STRETCH, self.max_batch), dtype=torch.long, device=self.device)
        self.spec_rounds = 0  # verify forwards: one a round
        self.spec_drafted = 0  # drafts of live slots consumed, and those accepted: the acceptance rate
        self.spec_accepted = 0

    def _spec_round(self, sampled: bool, verify: Callable):
        """One round for every slot from the static token and positions
        (JAX's spec_tick and spec_tick_sampled: speculative.spec_round over
        the draft's dense cache, drawing from the engine's sampler)."""
        sampling = (self.generator, self._sampler_kw, self._sampler_kw) if sampled else None
        return spec_round(self.draft, self._draft_fwd, self.draft_cache, self._tok, self._np, self.draft_k, verify,
                          sampling)

    def _spec_rounds(self, r: int, sampled: bool):
        """r rounds over the static buffers and the dense caches (JAX's
        spec_stretch and spec_stretch_sampled; r = 1 is its tick): round i's
        blocks into _blocks[i], its n_acc into _naccs[i]; live slots advance
        by n_acc + 1 with the correction as their next token (the device runs
        optimistically: the host applies the EOS, budget and window stops as
        it consumes the blocks), dead ones keep their token and position."""
        verify = lambda seq, pos: self._fwd(self.model.params, self.cfg, seq, pos, self.cache, pos)[0]
        for i in range(r):
            block, n_acc, correction = self._spec_round(sampled, verify)
            self._blocks[i].copy_(block)
            self._naccs[i].copy_(n_acc)
            self._np += torch.where(self._alive, n_acc + 1, 0).to(torch.int32)
            self._tok.copy_(torch.where(self._alive, correction, self._tok[:, 0])[:, None])

    def _spec_tick(self, active: np.ndarray):
        """A dense speculative tick: SPEC_STRETCH rounds in one dispatch when
        every live slot has window margin for their worst case (R * (k + 1)
        new positions), else one round; on the card one graph replay a
        dispatch (one capture per round count).  The host reads the blocks
        once and consumes them."""
        kk = self.draft_k
        live = np.nonzero(active)[0]
        r = SPEC_STRETCH if all(self.n_past[i] + SPEC_STRETCH * (kk + 1) < self._spec_margin for i in live) else 1
        sampled = self._sampler_kw is not None
        self._load_state(active, self._slot_budget())
        self._consume_spec_blocks(*self._spec_dispatch(("spec", r), lambda: self._spec_rounds(r, sampled), r),
                                  active)

    def _spec_dispatch(self, key, run: Callable, r: int):
        """run() (r rounds over the static buffers) eagerly on the CPU, as
        one graph replay on the card; returns their (blocks, n_accs), read
        on the host."""
        with torch.no_grad():
            if self.device.type != "cuda":
                run()
            else:
                self._replay(key, run, self._sampler_kw is not None, "spec")
            blocks, n_accs = self._blocks[:r].cpu().numpy().copy(), self._naccs[:r].cpu().numpy().copy()
        self.spec_rounds += r
        return blocks, n_accs

    def _spec_paged_round(self, sampled: bool):
        """One paged round over the static buffers: its verify writes the k +
        1 rows a slot straight into the slots' pages at (_pwpages, _pwoffs)
        (make_paged_verify_step); the draft keeps its dense cache."""
        verify = lambda seq, pos: self._paged_verify(self.model.params, self.mgr.pools, seq, pos, self._ptables,
                                                     self._pwpages, self._pwoffs, self._alive)[0]
        block, n_acc, _ = self._spec_round(sampled, verify)
        self._blocks[0].copy_(block)
        self._naccs[0].copy_(n_acc)

    def _spec_tick_paged(self, active: np.ndarray):
        """A paged speculative tick (JAX's spec_tick_paged and
        spec_tick_paged_sampled): one round, its inputs (tokens, positions,
        tables, the write coordinates of k + 1 rows a slot, the live mask)
        copied into static buffers, on the card one CUDA graph replay (its
        warm-up writes the rows the replay rewrites with the same values).
        Rejected rows are junk past the accepted length, rewritten by the
        next tick at the same (page, offset).  The pages for k + 1 rows were
        ensured by _tick."""
        mgr = self.mgr
        wpages, woffs = mgr.step_coords_multi(active, self.draft_k + 1)
        for buf, values in ((self._tok, self.cur_tok), (self._np, self.n_past), (self._alive, active),
                            (self._ptables, mgr.tables), (self._pwpages, wpages), (self._pwoffs, woffs)):
            self._put(buf, values)
        sampled = self._sampler_kw is not None
        self._consume_spec_blocks(*self._spec_dispatch(("spec_paged",), lambda: self._spec_paged_round(sampled), 1),
                                  active)
        for i in np.nonzero(active)[0]:  # accepted tokens advance the page view; rejected rows stay junk past it
            mgr.lengths[i] = self.n_past[i]

    def _consume_spec_blocks(self, blocks: np.ndarray, n_accs: np.ndarray, active: np.ndarray):
        """Apply fetched rounds (blocks (R, B, k + 1) of each round's accepted
        drafts and correction, n_accs (R, B)) with the real EOS, budget and
        window stops (the device ran optimistically), emitting the streaming
        callbacks."""
        for r in range(blocks.shape[0]):
            for i, s in enumerate(self.slots):
                if s is None or s.done or not active[i]:
                    continue
                self.spec_drafted += self.draft_k
                self.spec_accepted += int(n_accs[r, i])
                for tok in blocks[r, i, :n_accs[r, i] + 1]:
                    if s.done:
                        break
                    tok = int(tok)
                    self.n_past[i] += 1
                    s.out.append(tok)
                    self.cur_tok[i] = tok
                    if tok == self.eos_id or len(s.out) >= s.max_new_tokens or self.n_past[i] >= self._spec_margin:
                        s.done = True
                    if s.on_token is not None:
                        s.on_token(s.rid, tok, s.done)

    def _draft_prefill(self, toks: np.ndarray):
        """The draft's cache for a per-request admission: one prefill over
        toks (1, w), the sequence padded as the target's prefill pads it, into
        a fresh w-row slot cache, held until _admit installs it."""
        dslot = self._make_draft_cache(1, toks.shape[1])
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        with torch.no_grad(), self._span("prefill"):
            self._draft_fwd(self.draft.params, self.draft.cfg, self._to_device(toks), zero.expand(1), dslot, zero,
                            prefill=True, need_logits=False)
        self._pending_draft = dslot

    def _batched_draft_prefill(self, toks: np.ndarray, idx: torch.Tensor, n: int):
        """One draft prefill for an admission wave: toks (max_batch, w) over
        a fresh (max_batch, w) draft cache, the wave's n rows copied into
        their slots of the draft cache in place (rows past them dropped)."""
        B, w = toks.shape
        dslot = self._make_draft_cache(B, w)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        with torch.no_grad(), self._span("prefill"):
            self._draft_fwd(self.draft.params, self.draft.cfg, self._to_device(toks), zero.expand(B), dslot, zero,
                            prefill=True, need_logits=False)
            for big, small in zip(self.draft_cache, dslot):
                for b, s in zip(big, small):
                    b[:, :, :w].index_copy_(0, idx, s[:n])

    # -- internals ----------------------------------------------------------------

    def _slot_budget(self) -> np.ndarray:
        """(B,) remaining token budget per slot (0 for empty/done slots)."""
        return np.array([(s.max_new_tokens - len(s.out)) if (s is not None and not s.done) else 0
                         for s in self.slots], np.int32)

    def _consume_scan_outs(self, outs: np.ndarray, rids=None) -> bool:
        """Apply one fetched tick (h, B) to the host state with the SAME stop
        rules the device applied (EOS / budget / window), emitting the
        streaming callbacks.  rids: per-slot request ids at dispatch time (a
        slot freed and re-admitted while the tick was in flight ignores the
        old lane's masked tokens).  Returns True when any slot is done."""
        for j in range(outs.shape[0]):
            for i, s in enumerate(self.slots):
                if s is None or s.done:
                    continue
                if rids is not None and s.rid != rids[i]:
                    continue  # slot re-admitted mid-flight
                self.n_past[i] += 1
                tok = int(outs[j, i])
                s.out.append(tok)
                self.cur_tok[i] = tok
                if tok == self.eos_id or len(s.out) >= s.max_new_tokens or self.n_past[i] >= self.max_seq - 1:
                    s.done = True
                if s.on_token is not None:
                    s.on_token(s.rid, tok, s.done)
        return any(s is not None and s.done for s in self.slots)

    def _sim_tick(self, n_past, budget, alive, h: int):
        """Advance the host's prediction of the alive slots by one in-flight
        tick with the budget and window rules (EOS is unpredictable: an EOS'd
        slot wastes its lane for at most one extra tick)."""
        emit = np.minimum(h, np.minimum(budget, self.max_seq - 1 - n_past))
        emit = np.where(alive, np.maximum(emit, 0), 0)
        n_past = n_past + emit
        budget = budget - emit
        alive = alive & (budget > 0) & (n_past < self.max_seq - 1)
        return n_past, budget, alive

    def _stretch_admit(self, bucket: int, sampled: bool):
        """Admission without draining the pipeline: pop batchable fresh
        requests for the free slots and run their batched prefill, enqueued
        after the in-flight tick on the same stream (it reads no host value).
        Returns (admitted [(slot, req, t)], must_break): must_break when the
        most urgent queued request needs the out-of-stretch path (a snapshot,
        a fork share, an over-window sequence or a sampling-mode flip)."""
        admitted: list[tuple[int, Request, int]] = []
        must_break = False
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.queue:
                continue
            req = min(self.queue, key=lambda r: r.priority)
            if (req.snapshot is not None or req.share is not None or len(req.seq) >= self.max_seq
                    or bool(self._any_slot_sampling) != sampled):
                must_break = True
                break
            self.queue.remove(req)
            self.slots[i] = req
            self._slot_sampling_set(i, req)
            admitted.append((i, req, len(req.seq)))
        if admitted and self.prefill_chunk:
            # one wave of (max_batch, C) chunk dispatches: a long prompt
            # admitted mid-stretch costs ceil(t / C) bounded dispatches
            self._prefill_into_slots_chunked(admitted)
        else:
            self._prefill_groups(admitted, bucket)
        return admitted, must_break

    def _scatter_slot_state(self, admitted):
        """Overwrite the device decode state of freshly admitted slots only
        (the others are ahead of the host while a tick is in flight)."""
        idx = self._to_device([i for i, _, _ in admitted])
        self._put(self._tok, [self.cur_tok[i] for i, _, _ in admitted], idx)
        self._put(self._np, [self.n_past[i] for i, _, _ in admitted], idx)
        self._alive.index_fill_(0, idx, True)
        self._put(self._budget, [req.max_new_tokens - len(req.out) for _, req, _ in admitted], idx)
        self._put(self._temp, self._slot_temp)
        self._put(self._topp, self._slot_topp)

    def _run_scan_stretch(self, abort_callback=None, results=None, bucket: int = 32) -> bool:
        """Pipelined multi-step decode: the (token, n_past, alive, budget)
        state stays on the device across ticks and tick t+1 is enqueued before
        tick t's ids are read, so the host's bookkeeping overlaps the card.
        With `results`, admission rides the pipeline too: finished slots are
        swept in place and queued fresh requests prefill behind the in-flight
        tick, their decode state scattered into the buffers (each in-flight
        tick carries a slot -> rid snapshot).  Returns True if the abort
        callback fired."""
        alive_h = np.array([s is not None and not s.done for s in self.slots])
        if not alive_h.any():
            return False
        hb = self._hb
        budget_h = self._slot_budget()
        self._load_state(alive_h, budget_h)
        sampled = bool(self._any_slot_sampling)
        # host prediction of the slots alive after the in-flight tick (exact
        # for budget and window, optimistic for EOS)
        p_np, p_budget, p_alive = self.n_past.copy(), budget_h.copy(), alive_h.copy()
        pending = None  # (handle, rid snapshot)

        def rid_snapshot():
            return [s.rid if s is not None else -1 for s in self.slots]

        def drain():
            if pending is not None:
                self._consume_scan_outs(self._fetch(pending[0]), pending[1])

        def sweep():
            for i, s in enumerate(self.slots):
                if s is not None and s.done:
                    results[s.rid] = s.out
                    self.slots[i] = None

        while True:
            if abort_callback is not None and abort_callback():
                drain()
                return True
            must_break = False
            if results is not None and self.queue and any(s is None for s in self.slots):
                admitted, must_break = self._stretch_admit(bucket, sampled)
                if admitted:
                    self._scatter_slot_state(admitted)
                    # new slots enter the prediction; the in-flight tick never
                    # advances them (dead lanes at its dispatch)
                    for i, req, _t in admitted:
                        p_np[i] = self.n_past[i]
                        p_budget[i] = req.max_new_tokens - len(req.out)
                        p_alive[i] = True
            if must_break:
                drain()
                if results is not None:
                    sweep()
                return False
            newtick = None
            if p_alive.any():
                newtick = (self._dispatch(sampled), rid_snapshot())
                p_np, p_budget, p_alive = self._sim_tick(p_np, p_budget, p_alive, hb)
            if pending is not None:
                finished = self._consume_scan_outs(self._fetch(pending[0]), pending[1])
                if finished:
                    # resync the prediction from the real post-consume state
                    p_alive = np.array([s is not None and not s.done for s in self.slots])
                    p_budget = self._slot_budget()
                    p_np = self.n_past.copy()
                    if newtick is not None:
                        p_np, p_budget, p_alive = self._sim_tick(p_np, p_budget, p_alive, hb)
                    if results is not None:
                        sweep()  # free slots; the next iteration admits in the pipe
                    elif self.queue:
                        if newtick is not None:
                            self._consume_scan_outs(self._fetch(newtick[0]), newtick[1])
                        return False
                if self.queue and not all(s is None or s.done for s in self.slots):
                    # an urgent arrival (submitted from a streaming callback)
                    # outranking a running slot must not wait out the stretch
                    head = min(self.queue, key=lambda r: r.priority)
                    running = [s for s in self.slots if s is not None and not s.done]
                    if running and max(r.priority for r in running) > head.priority:
                        if newtick is not None:
                            self._consume_scan_outs(self._fetch(newtick[0]), newtick[1])
                        if results is not None:
                            sweep()
                        return False
            pending = newtick
            if pending is None:
                if results is not None:
                    sweep()
                return False

    def _snapshot_slot(self, i: int, req: Request):
        """Device->host KV eviction: spill the slot's rows [0, n_past) (the
        next step writes row n_past), or its pages [0, ceil(n_past / page)),
        so that resume restores them instead of re-prefilling the sequence."""
        n_past = int(self.mgr.lengths[i]) if self.paged is not None else int(self.n_past[i])
        if n_past <= 0:
            return
        # a copy also where the cache is on the CPU (there .cpu() would alias it)
        spill = lambda x: x.to("cpu", copy=True)
        if self.paged is None:
            host = [(spill(k[:, :, :n_past]), spill(v[:, :, :n_past])) for k, v in cache_slot(self.cache, i)]
        else:
            pages = -(-n_past // self.paged.page_size)
            host = [(spill(k), spill(v)) for k, v in self.mgr.gather_prefix(i, pages)]
        draft = None
        if self.draft is not None:
            draft = [(spill(k[:, :, :n_past]), spill(v[:, :, :n_past])) for k, v in cache_slot(self.draft_cache, i)]
        req.snapshot = {"cache": host, "n_past": n_past, "cur_tok": int(self.cur_tok[i]), "draft": draft}

    def _resume_from_snapshot(self, i: int, req: Request) -> bool:
        """Restore an evicted slot's KV from its host snapshot.  Returns False
        (the request queued again) while its pages are not available."""
        snap = req.snapshot
        t = snap["n_past"]
        if self.paged is not None:
            need = -(-(t + 1) // self.paged.page_size)
            if need > self.mgr.free_pages():
                if self.mgr.free_pages() == self.paged.n_pages:
                    raise ValueError(f"snapshot of {t} tokens cannot fit an empty page pool "
                                     f"({self.paged.n_pages} pages)")
                self.queue.append(req)
                return False
            assert self.mgr.ensure_capacity(i, t + 1)
            self.mgr.install_prefill(i, snap["cache"], t)
        else:
            cache_set_slot(self.cache, snap["cache"], i)
        if snap.get("draft") is not None:
            cache_set_slot(self.draft_cache, snap["draft"], i)
        self.slots[i] = req
        self._slot_sampling_set(i, req)
        self.n_past[i] = t
        self.cur_tok[i] = snap["cur_tok"]
        req.snapshot = None
        return True

    def _preempt_for_priority(self):
        """If the most urgent queued request outranks the least urgent running
        one and no slot is free, evict that slot back to the queue with its
        KV snapshotted to the host."""
        if not self.queue or any(s is None for s in self.slots):
            return
        head = min(self.queue, key=lambda r: r.priority)
        running = [(i, s) for i, s in enumerate(self.slots) if s is not None and not s.done]
        if not running:
            return
        i, worst = max(running, key=lambda kv: kv[1].priority)
        if worst.priority > head.priority:
            self._evict(i, worst)

    def _evict(self, i: int, req: Request):
        req.preempted += 1
        self._snapshot_slot(i, req)
        self.queue.append(req)
        self.slots[i] = None
        if self.paged is not None:
            self.mgr.release(i)

    def _bucket(self, t: int, bucket: int) -> int:
        return min(self.max_seq, -(-t // bucket) * bucket)

    def _page_rows(self, t: int) -> int:
        """Rows of a slot cache that install_prefill reads for t tokens: whole
        pages (0 on a dense engine)."""
        return 0 if self.paged is None else -(-t // self.paged.page_size) * self.paged.page_size

    def _prefill(self, seq, bucket: int):
        """Single-slot prefill (a fork group's shared prompt, a paged
        admission); returns (last logits | None, slot cache, t, tb).  Bucketed:
        logits is None when the bucket padded past t (the caller re-decodes
        the true last token), and then the head is not run at all.  The slot
        cache has tb rows, or the whole pages of t on a paged engine.  With
        prefill_chunk the prompt runs in chunks (_prefill_chunked).  A
        speculative engine prefills the draft over the same tokens
        (_draft_prefill)."""
        if self.prefill_chunk:
            return self._prefill_chunked(seq)
        t = len(seq)
        tb = self._bucket(t, bucket)
        toks = np.zeros((1, tb), np.int64)
        toks[0, :t] = seq
        if self.draft is not None:
            self._draft_prefill(toks)
        slot_cache = self._make_cache(1, max(tb, self._page_rows(t)))
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        self.prefill_count += 1
        with torch.no_grad(), self._span("prefill"):
            logits, _ = self._fwd(self.model.params, self.cfg, self._to_device(toks), zero.expand(1), slot_cache, zero,
                                  prefill=True, need_logits=t == tb)
        return (logits[:, -1, :] if t == tb else None), slot_cache, t, tb

    def _prefill_suffix(self, seq, pre_len: int, slot: int, bucket: int):
        """Prefix-cache hit: the shared pages hold the KV of positions [0,
        pre_len).  Seed a dense slot cache with them in one pass, then run the
        populated-cache forward over the suffix alone.  Returns (last logits |
        None, slot cache), with _prefill's bucket-padding contract.  The
        draft, which has no pages, prefills the whole sequence as _prefill
        would."""
        t = len(seq)
        if self.draft is not None:
            toks = np.zeros((1, self._bucket(t, bucket)), np.int64)
            toks[0, :t] = seq
            self._draft_prefill(toks)
        st = t - pre_len
        sb = min(self.max_seq - pre_len, -(-st // bucket) * bucket)
        toks = np.zeros((1, sb), np.int64)
        toks[0, :st] = seq[pre_len:]
        slot_cache = self._make_cache(1, max(pre_len + sb, self._page_rows(t)))
        pos = self._to_device([pre_len], torch.int32)
        self.prefill_count += 1
        self.cached_prefix_tokens += pre_len
        with torch.no_grad(), self._span("prefill"):
            for (kc, vc), (kd, vd) in zip(slot_cache, self.mgr.gather_prefix(slot, pre_len // self.paged.page_size)):
                kc[:, :, :pre_len].copy_(kd)
                vc[:, :, :pre_len].copy_(vd)
            logits, _ = self._fwd(self.model.params, self.cfg, self._to_device(toks), pos, slot_cache, pos,
                                  need_logits=st == sb)
        return (logits[:, -1, :] if st == sb else None), slot_cache

    def _prefill_chunked(self, seq):
        """Fixed-chunk prefill of one prompt (forks, paged admission):
        ceil(t / C) populated-cache steps of C tokens over a max_seq-row slot
        cache (positions carried by cache_len, the pad masked by position), no
        head.  Returns (None, slot cache, t, t): the caller re-decodes the last
        token for position-exact logits, as after bucket padding.  The draft
        prefills the whole sequence in one forward over the C-rounded width."""
        C = self.prefill_chunk
        t = len(seq)
        if self.draft is not None:
            toks = np.zeros((1, min(self.max_seq, -(-t // C) * C)), np.int64)
            toks[0, :t] = seq
            self._draft_prefill(toks)
        slot_cache = self._make_cache(1, max(self.max_seq, self._page_rows(t)))
        self.prefill_count += 1
        with torch.no_grad():
            for a in range(0, t, C):
                chunk = np.zeros((1, C), np.int64)
                chunk[0, :min(C, t - a)] = seq[a:a + C]
                pos = self._to_device([a], torch.int32)
                with self._span("chunk"):
                    self._fwd(self.model.params, self.cfg, self._to_device(chunk), pos, slot_cache, pos,
                              need_logits=False)
                self.chunk_dispatches += 1
        return None, slot_cache, t, t

    def _slot_sampling_set(self, i: int, req: Request):
        """Install the slot's sampling parameters when it takes slot i."""
        s = req.sampling or {}
        self._slot_temp[i] = float(s.get("temperature", self._default_temp))
        self._slot_topp[i] = float(s.get("top_p", self._default_topp))

    def _emit_first(self, req: Request, i: int, logits):
        """Sample or argmax the first post-prefill token for slot i."""
        sampled = bool(self._any_slot_sampling)
        with torch.no_grad():
            temp = self._to_device(self._slot_temp[i:i + 1, None], torch.float32)
            topp = self._to_device(self._slot_topp[i:i + 1, None], torch.float32)
            tok = int(self._pick(logits, sampled, temp, topp)[0])
        self.cur_tok[i] = tok
        req.out.append(tok)
        if tok == self.eos_id or len(req.out) >= req.max_new_tokens:
            req.done = True
        if req.on_token is not None:
            req.on_token(req.rid, tok, req.done)

    def _admit(self, bucket: int):
        self._preempt_for_priority()
        # plain fresh dense prefills batch into ONE prefill per bucket size
        # (or one chunked wave); snapshots, forks and every paged admission
        # (its pages, its prefix) keep the per-request path
        batchable = self.paged is None
        deferred: list[tuple[int, Request, int]] = []
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.queue:
                continue
            req = min(self.queue, key=lambda r: r.priority)  # stable: first min
            self.queue.remove(req)
            if req.snapshot is not None:  # evicted mid-run: restore its KV
                self._resume_from_snapshot(i, req)
                continue
            seq = req.seq  # the prompt, or prompt + output when resuming
            t = len(seq)
            if t >= self.max_seq:  # cannot resume within the window
                req.done = True
                self.slots[i] = req
                continue
            if batchable and req.share is None:
                self.slots[i] = req
                self._slot_sampling_set(i, req)
                deferred.append((i, req, t))
                continue
            matched = 0
            if self.paged is not None:
                # reserve the prompt and one decode step BEFORE prefilling, so
                # a request that cannot get pages waits without re-prefilling;
                # attach published pages covering a page-aligned prefix (keep
                # at least one suffix token for the next-token logits)
                ps = self.paged.page_size
                pages = self.mgr.match_prefix(seq) if req.share is None else []
                pages = pages[:max(0, (t - 1) // ps)]
                matched = len(pages)
                need = -(-(t + 1) // ps) - matched
                if need > self.mgr.free_pages():
                    if self.mgr.free_pages() == self.paged.n_pages:
                        raise ValueError(f"request of {t} tokens cannot fit an empty page pool "
                                         f"({self.paged.n_pages} pages)")
                    self.queue.append(req)  # wait for pages
                    continue
                if matched:
                    self.mgr.attach_prefix(i, pages)
            if req.share is not None and not req.out:
                if req.share.cache is None:  # the first of the fork group
                    req.share.logits, req.share.cache, req.share.t, _ = self._prefill(seq, bucket)
                    req.share.draft = self._pending_draft
                logits, slot_cache, t = req.share.logits, req.share.cache, req.share.t
                self._pending_draft = req.share.draft
            elif matched:
                assert self.mgr.ensure_capacity(i, t + 1)
                logits, slot_cache = self._prefill_suffix(seq, matched * self.paged.page_size, i, bucket)
            else:
                logits, slot_cache, t, _ = self._prefill(seq, bucket)
            if self.paged is not None:
                assert self.mgr.ensure_capacity(i, t + 1)
                self.mgr.install_prefill(i, slot_cache, t, from_page=matched)
                self.mgr.publish_prefix(i, req.prompt)
            else:
                cache_set_slot(self.cache, slot_cache, i)
            if self.draft is not None:
                cache_set_slot(self.draft_cache, self._pending_draft, i)
            self.slots[i] = req
            self._slot_sampling_set(i, req)
            self.n_past[i] = t
            if logits is not None:
                self._emit_first(req, i, logits)
            else:
                # bucket padding wrote junk past t: re-decode the true last
                # token for position-exact logits
                self.n_past[i] = t - 1
                self.cur_tok[i] = int(seq[-1])
            if self.paged is not None:
                self.mgr.lengths[i] = self.n_past[i]
        if deferred and self.prefill_chunk:
            self._prefill_into_slots_chunked(deferred)
        else:
            self._prefill_groups(deferred, bucket)

    def _prefill_groups(self, admitted, bucket: int):
        groups: dict[int, list] = {}
        for item in admitted:
            groups.setdefault(self._bucket(item[2], bucket), []).append(item)
        for tb in sorted(groups):
            self._prefill_into_slots(groups[tb], tb)

    def _prefill_into_slots(self, group, tb: int):
        """ONE (max_batch, tb) prefill admits every request of `group` [(slot,
        req, t)] over a fresh multi-slot cache of tb rows (rows the engine
        cache has at [0, tb)), then copies the group's rows into its slots
        in place.  Rows past the group are dropped explicitly (JAX drops them
        through out-of-range scatter indices; a PyTorch index past the end
        would raise).  The head is not run: the prefill's logits are never
        read (XLA drops them from the JAX program).  Nothing is read on the
        host, so admission rides inside a pipelined stretch."""
        B = self.max_batch
        toks = np.zeros((B, tb), np.int64)
        for r, (i, req, t) in enumerate(group):
            toks[r, :t] = req.seq
        slot_cache = self._make_cache(B, tb)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        idx = self._to_device([i for i, _, _ in group])
        n = len(group)
        with torch.no_grad(), self._span("prefill"):
            self._fwd(self.model.params, self.cfg, self._to_device(toks), zero.expand(B), slot_cache, zero,
                      prefill=True, need_logits=False)
            for big, small in zip(self.cache, slot_cache):
                for b, s in zip(big, small):
                    b[:, :, :tb].index_copy_(0, idx, s[:n])
        if self.draft is not None:
            self._batched_draft_prefill(toks, idx, n)
        self.prefill_count += n
        for i, req, t in group:
            # re-decode the true last token for position-exact logits (its
            # row is rewritten identically): the first token comes from the
            # batched step, and admission never reads the card
            self.n_past[i] = t - 1
            self.cur_tok[i] = int(req.seq[-1])

    def _prefill_into_slots_chunked(self, group):
        """Batched chunked admission: every request of `group` [(slot, req,
        t)] prefills in ceil(max t / C) (max_batch, C) dispatches over the
        engine's multi-slot chunk cache, then one copy installs the group's
        rows into its slots.  The chunk cache is made once and reused (JAX
        makes a fresh one a wave): its rows past each prompt hold junk the
        attention masks by position.  A dispatch runs no head.  Nothing is
        read on the host, so a wave rides inside a pipelined stretch."""
        B, C = self.max_batch, self.prefill_chunk
        maxt = max(t for _, _, t in group)
        if self._chunk_cache is None:
            self._chunk_cache = self._make_cache(B)
        idx = self._to_device([i for i, _, _ in group])
        n = len(group)
        with torch.no_grad():
            for a in range(0, maxt, C):
                toks = np.zeros((B, C), np.int64)
                for r, (i, req, t) in enumerate(group):
                    seg = req.seq[a:a + C]
                    toks[r, :len(seg)] = seg
                pos = torch.full((), a, dtype=torch.int32, device=self.device)
                with self._span("chunk"):
                    self._fwd(self.model.params, self.cfg, self._to_device(toks), pos.expand(B), self._chunk_cache,
                              pos, need_logits=False)
                self.chunk_dispatches += 1
            rows = min(self.max_seq, -(-maxt // C) * C)
            with self._span("prefill"):
                for big, small in zip(self.cache, self._chunk_cache):
                    for b, s in zip(big, small):
                        b[:, :, :rows].index_copy_(0, idx, s[:n, :, :rows])
        if self.draft is not None:
            # the draft over the whole prompts at the C-rounded width: a stale
            # draft cache would not change an id (the verify decides) but
            # would collapse acceptance
            dtoks = np.zeros((B, rows), np.int64)
            for r, (i, req, t) in enumerate(group):
                dtoks[r, :t] = req.seq
            self._batched_draft_prefill(dtoks, idx, n)
        self.prefill_count += n
        for i, req, t in group:  # the re-decode contract of _prefill_into_slots
            self.n_past[i] = t - 1
            self.cur_tok[i] = int(req.seq[-1])

    def _evict_for_pages(self, need_slot: int) -> bool:
        """Free pages by preempting the least urgent OTHER running slot (its
        KV snapshotted to the host)."""
        victims = [(j, s) for j, s in enumerate(self.slots) if s is not None and not s.done and j != need_slot]
        if not victims:
            return False
        j, worst = max(victims, key=lambda kv: kv[1].priority)
        self._evict(j, worst)
        return True

    def _tick(self):
        """One tick from the host state, read back at once: the path of
        direct _admit/_tick use (the server's loop, the tests) and of every
        paged tick.  Dense: h steps (one graph replay on the card).  Paged:
        each live slot's next page first (evicting under pressure), then a
        greedy stretch of h steps when every live slot has room for them, or
        one step.  A speculative engine runs _spec_tick or _spec_tick_paged,
        its pages grown by draft_k + 1 rows a slot."""
        active = np.array([s is not None and not s.done for s in self.slots])
        if self.paged is not None:
            grow = self.draft_k + 1 if self.draft is not None else 1  # the rows a tick writes
            for i in np.nonzero(active)[0]:
                i = int(i)
                if self.slots[i] is None:  # evicted for an earlier slot's page
                    continue
                while not self.mgr.ensure_capacity(i, int(self.mgr.lengths[i]) + grow):
                    if not self._evict_for_pages(i):  # nothing left to evict: requeue this request too
                        self._evict(i, self.slots[i])
                        break
            active &= np.array([s is not None for s in self.slots])
            if active.any():
                (self._spec_tick_paged if self.draft is not None else self._paged_tick)(active)
            return
        if not active.any():
            return
        if self.draft is not None:
            self._spec_tick(active)
            return
        self._load_state(active, self._slot_budget())
        self._consume_scan_outs(self._fetch(self._dispatch(bool(self._any_slot_sampling))))

    def _paged_tick(self, active: np.ndarray):
        """Greedy stretch: h steps as one scan (one graph replay on the card)
        when no slot samples and every live slot has budget and window for h
        tokens and the pages for them (h halves until it fits); else one
        paged step, its ids picked on the device as the dense step picks."""
        mgr, B = self.mgr, self.max_batch
        live = [i for i in range(B) if active[i]]
        if not self._any_slot_sampling and self._hb > 1:
            budgets = self._slot_budget()
            win = self.paged.max_pages_per_seq * self.paged.page_size
            room = min((min(int(budgets[i]), win - 1 - int(mgr.lengths[i])) for i in live), default=0)
            h = self._hb
            while h > 1 and h > room:
                h //= 2
            if h > 1 and all(mgr.ensure_capacity(i, int(mgr.lengths[i]) + h) for i in live):
                wpages, woffs = mgr.step_coords_multi(active, h)
                outs = self._paged_scan(self.model.params, mgr.pools, self.cur_tok.reshape(-1, 1), mgr.lengths,
                                        mgr.tables, wpages, woffs, active, h, put=self._put, span=self._span)
                self.decode_steps += h
                self._consume_scan_outs(outs)
                for i in live:  # rewind the page views the scan advanced past a stop
                    mgr.lengths[i] = self.n_past[i]
                return
        wpage, woff = mgr.step_coords(active)
        dev = lambda a, dt=torch.long: self._to_device(a, dt)
        sampled = bool(self._any_slot_sampling)
        with torch.no_grad():
            logits, _ = self._paged_step(self.model.params, mgr.pools, dev(self.cur_tok.reshape(-1, 1)),
                                         dev(mgr.lengths), dev(mgr.tables), dev(wpage), dev(woff),
                                         dev(active, torch.bool))
            temp, topp = (dev(self._slot_temp[:, None], torch.float32),
                          dev(self._slot_topp[:, None], torch.float32)) if sampled else (None, None)
            nxt = self._pick(logits, sampled, temp, topp).cpu().numpy()
        self.decode_steps += 1
        mgr.lengths[active] += 1
        self._consume_scan_outs(np.where(active, nxt, 0)[None])
