"""Paged KV cache: a physical page pool and logical page tables (port of
ggml_tpu/paged_kv.py).

The engine's dense cache reserves max_batch x max_seq rows per slot.  Paging
decouples capacity from the worst case: a shared pool of fixed-size pages is
allocated to sequences on demand, so the KV memory follows the SUM of live
context lengths (vLLM's PagedAttention, with static shapes):

- the pools are per-layer (n_pages + 1, H_kv, page_size, D) tensors on the
  model's device, allocated once and written in place (a captured graph keeps
  their addresses); allocation is host-side (a free list) and reaches the
  device only as page ids in the tables;
- a decode step gathers each slot's pages (`pool[table[b]]`) into its logical
  window and attends over it in plain f32 PyTorch with every row past the
  slot's position masked, as the JAX step does outside any Pallas kernel;
- writes scatter one (page, offset) row per slot (paged_write);
- automatic prefix caching: completed prompt prefills publish their full
  pages under a hash chain of their tokens; a later prompt with the same
  page-aligned prefix attaches them read-only and prefills only its suffix.
  Unreferenced published pages form an LRU reserve reclaimed under pressure.

The paged stretch (make_paged_decode_scan) runs h greedy steps as ONE CUDA
graph replay on the card over static buffers the host fills by copy_; one
capture per h.  make_paged_verify_step is the multi-token step of
speculative decoding: T = draft_k + 1 rows a slot written into their pages.
The linears go through the port's planar_matmul kernels.

DeepSeek's MLA pools hold the compressed latent and the shared rope key of
a token (an asymmetric pair, (n_pages + 1, 1, page_size, kv_lora_rank) and
(..., qk_rope_dim)); its step attends over them in the absorbed form.  The
gemma family and Phi-3 have their own steps too (softcaps and per-layer
windows; LongRoPE chosen by the window's length); Phi-2, GPT-NeoX, Falcon,
GPT-2 and the mixture-of-experts families run the generic adapter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .models.common import capture_graph, count_replays


@dataclass
class PagedConfig:
    n_pages: int  # pool size (shared by all slots, per layer)
    page_size: int  # tokens per page
    max_pages_per_seq: int  # logical window = page_size * max_pages_per_seq
    prefix_cache: bool = False  # automatic prefix caching


class PagedKVManager:
    """Host-side allocator and device-side pools for one model.

    Pools: per layer (k_pool, v_pool) of (n_pages + 1, H_kv, page_size, D);
    the last page is the TRASH page that absorbs the writes of inactive slots.
    head_dim: an int for symmetric (k, v) pools, or a (dk, dv) pair (the MLA
    pools: dk = kv_lora_rank, dv = qk_rope_dim, one head).
    Tables: (max_batch, max_pages_per_seq) int32 page ids on the host;
    unallocated entries hold 0 and are masked by the per-slot lengths."""

    def __init__(self, n_layer: int, n_kv_heads: int, head_dim, max_batch: int, pcfg: PagedConfig,
                 dtype=torch.bfloat16, device="cuda"):
        self.pcfg = pcfg
        self.device = torch.device(device)
        dk, dv = head_dim if isinstance(head_dim, (tuple, list)) else (head_dim, head_dim)
        mk = lambda d: torch.zeros((pcfg.n_pages + 1, n_kv_heads, pcfg.page_size, d), dtype=dtype, device=device)
        self.trash_page = pcfg.n_pages
        self.pools = [(mk(dk), mk(dv)) for _ in range(n_layer)]
        self.tables = np.zeros((max_batch, pcfg.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self._free = list(range(pcfg.n_pages - 1, -1, -1))  # pop() -> page 0 first
        self._owned: list[list[int]] = [[] for _ in range(max_batch)]
        # prefix cache: published pages keyed by the hash CHAIN of their
        # page-aligned token history; _shared_ref counts the slots using a
        # page; _lru orders the reclaimable (unreferenced) published pages
        self._attached: list[list[int]] = [[] for _ in range(max_batch)]
        self._hash_to_page: dict = {}
        self._page_hash: dict[int, object] = {}
        self._shared_ref: dict[int, int] = {}
        self._lru: list[int] = []  # unreferenced published pages, oldest first

    # -- prefix cache -----------------------------------------------------------

    @staticmethod
    def _chain_hashes(tokens, page_size: int):
        """Hash chain over the full pages of the token sequence (Python's
        str hash is salted per process: compare pages, never hash values)."""
        out, h = [], "root"
        for j in range(len(tokens) // page_size):
            h = hash((h, tuple(int(t) for t in tokens[j * page_size:(j + 1) * page_size])))
            out.append(h)
        return out

    def match_prefix(self, tokens) -> list[int]:
        """The longest chain of published pages covering a page-aligned prefix."""
        if not self.pcfg.prefix_cache:
            return []
        pages = []
        for h in self._chain_hashes(tokens, self.pcfg.page_size):
            pg = self._hash_to_page.get(h)
            if pg is None:
                break
            pages.append(pg)
        return pages

    def attach_prefix(self, slot: int, pages: list[int]):
        """Point the slot's leading table entries at shared pages."""
        for j, pg in enumerate(pages):
            self.tables[slot, j] = pg
            self._shared_ref[pg] = self._shared_ref.get(pg, 0) + 1
            if pg in self._lru:
                self._lru.remove(pg)
        self._attached[slot] = list(pages)

    def publish_prefix(self, slot: int, tokens):
        """Publish the slot's FULL prompt pages (beyond any attached prefix)
        so that later prompts can share them: each becomes shared, with this
        slot holding one reference, and outlives the slot in the LRU reserve."""
        if not self.pcfg.prefix_cache:
            return
        hashes = self._chain_hashes(tokens, self.pcfg.page_size)
        own = list(self._owned[slot])
        for j in range(len(self._attached[slot]), len(hashes)):
            h = hashes[j]
            if h in self._hash_to_page:
                continue
            pg = int(self.tables[slot, j])
            if pg not in own:
                continue  # the page is attached (shared) already
            own.remove(pg)
            self._attached[slot].append(pg)
            self._hash_to_page[h] = pg
            self._page_hash[pg] = h
            self._shared_ref[pg] = self._shared_ref.get(pg, 0) + 1
        self._owned[slot] = own

    def _reclaim_one(self) -> bool:
        """Unpublish the least recently used unreferenced shared page."""
        if not self._lru:
            return False
        pg = self._lru.pop(0)
        del self._hash_to_page[self._page_hash.pop(pg)]
        self._shared_ref.pop(pg, None)
        self._free.append(pg)
        return True

    def step_coords(self, active: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(wpage, woff) for EVERY batch row: a live row gets its next
        position's coordinates, an inactive row the trash page."""
        wpages, woffs = self.step_coords_multi(active, 1)
        return wpages[:, 0], woffs[:, 0]

    def step_coords_multi(self, active: np.ndarray, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(wpages, woffs) of shape (B, t): the write coordinates of the next
        t positions of each live row; an inactive row writes the trash page.
        The caller has ensured capacity for lengths + t."""
        b = len(active)
        wpages = np.full((b, t), self.trash_page, np.int32)
        woffs = np.zeros((b, t), np.int32)
        ps = self.pcfg.page_size
        for i in range(b):
            if active[i]:
                pos = int(self.lengths[i]) + np.arange(t)
                wpages[i] = self.tables[i, pos // ps]
                woffs[i] = pos % ps
        return wpages, woffs

    # -- host-side allocation ---------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free) + len(self._lru)  # LRU pages are reclaimable

    def ensure_capacity(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's pages to cover n_tokens positions.  Returns False
        (allocating nothing) when the pool cannot: the caller evicts or waits."""
        ps = self.pcfg.page_size
        need = -(-n_tokens // ps)
        if need > self.pcfg.max_pages_per_seq:
            raise ValueError(f"{n_tokens} tokens exceed the logical window ({self.pcfg.max_pages_per_seq} pages "
                             f"x {ps})")
        have = len(self._attached[slot]) + len(self._owned[slot])
        if need - have > self.free_pages():
            return False
        for j in range(have, need):
            if not self._free:
                assert self._reclaim_one()
            pg = self._free.pop()
            self._owned[slot].append(pg)
            self.tables[slot, j] = pg
        return True

    def _page_ids(self, slot: int, start: int, stop: int) -> torch.Tensor:
        return torch.as_tensor(self.tables[slot, start:stop].astype(np.int64)).to(self.device)

    def install_prefill(self, slot: int, slot_cache, t: int, from_page: int = 0):
        """Copy a dense single-slot cache (per layer (k, v) of (1, H, S, D),
        S >= the pages' rows; on the device or a host snapshot) into the
        slot's pages [from_page, ceil(t / page_size)): prefill runs through
        the dense forward, then the pages take over for decode.  from_page
        skips attached (shared) prefix pages.  One index_copy_ a buffer."""
        ps = self.pcfg.page_size
        npg = -(-t // ps)
        n_eff = npg - from_page
        self.lengths[slot] = t
        if n_eff <= 0:
            return
        pages = self._page_ids(slot, from_page, npg)
        for (kp, vp), (kc, vc) in zip(self.pools, slot_cache):
            for pool, buf in ((kp, kc), (vp, vc)):
                rows = buf[0, :, from_page * ps:npg * ps, :]  # (H, n_eff * ps, D)
                h, _, d = rows.shape
                blocks = rows.reshape(h, n_eff, ps, d).transpose(0, 1)
                pool.index_copy_(0, pages, blocks.to(pool.device, pool.dtype))

    def gather_prefix(self, slot: int, n_pages: int) -> list:
        """Dense (1, H, n_pages * page_size, D) copies of the slot's leading
        pages per layer: the context of a suffix prefill after a prefix hit."""
        pages = self._page_ids(slot, 0, n_pages)
        return [(_window(kp[pages])[None], _window(vp[pages])[None]) for kp, vp in self.pools]

    def release(self, slot: int):
        for pg in self._attached[slot]:
            self._shared_ref[pg] -= 1
            if self._shared_ref[pg] == 0:
                self._lru.append(pg)  # stays published, reclaimable
        self._attached[slot] = []
        self._free.extend(self._owned[slot])
        self._owned[slot] = []
        self.tables[slot] = 0
        self.lengths[slot] = 0


def _window(blocks: torch.Tensor) -> torch.Tensor:
    """(..., P, H, ps, D) pages -> (..., H, P * ps, D) logical window."""
    *lead, p, h, ps, d = blocks.shape
    return blocks.transpose(-4, -3).reshape(*lead, h, p * ps, d)


def paged_write(pool_kv: torch.Tensor, kv: torch.Tensor, page_ids: torch.Tensor, offsets: torch.Tensor):
    """Scatter one token per slot into the pool IN PLACE: pool_kv (n_pages, H,
    ps, D), kv (B, H, D) this step's K or V rows, page_ids and offsets (B,)
    long tensors.  Duplicate (page, offset) pairs do not occur (each live
    slot owns its pages; inactive ones write the trash page, whose rows
    nobody reads).  Reads no host value, so a graph captures it."""
    pool_kv[page_ids, :, offsets] = kv.to(pool_kv.dtype)
    return pool_kv


def paged_gather(pool_kv: torch.Tensor, table) -> torch.Tensor:
    """The logical window of slots: pool (n_pages, H, ps, D) at table (P,) ->
    (H, P * ps, D), or at tables (B, P) -> (B, H, P * ps, D).  Rows past a
    slot's length are garbage the mask removes."""
    return _window(pool_kv[table])


def make_paged_decode_step(model, pcfg: PagedConfig, forward_fn=None):
    """One-token decode step over paged KV: step(params, pools, tokens (B,1),
    lengths (B,), tables (B,P), wpage (B,), woff (B,), active (B,)), every
    index a long tensor on the model's device -> (logits (B, vocab), pools),
    the pools written in place.  Slots at distinct positions (continuous
    batching).  GPT-J, the llama family, the gemma family, Phi-3 and
    Deepseek have their own steps; every other family (given forward_fn)
    runs the generic adapter over its forward (ggml_tpu/paged_kv.py:338)."""
    from .models import deepseek, gemma2, gptj, llama, phi3

    if isinstance(model, gptj.GPTJ):
        return _make_paged_step_gptj(model, pcfg)
    if isinstance(model, gemma2.Gemma2):
        return _make_paged_step_gemma2(model, pcfg)
    if isinstance(model, deepseek.Deepseek):
        return _make_paged_step_deepseek(model, pcfg)
    if isinstance(model, phi3.Phi3):
        return _make_paged_step_phi3(model, pcfg)
    if isinstance(model, llama.Llama):
        gen = _make_paged_llama_general(model, pcfg)

        def step(params, pools, tokens, lengths, tables, wpage, woff, active):
            logits, pools = gen(params, pools, tokens, lengths, tables, wpage[:, None], woff[:, None], active)
            return logits[:, 0], pools

        return step
    if forward_fn is None:
        raise TypeError(f"no specialized paged step for {type(model).__name__} and no forward_fn given for the "
                        "generic adapter")
    return _make_paged_step_generic(model, pcfg, forward_fn)


def make_paged_verify_step(model, pcfg: PagedConfig, forward_fn=None):
    """The multi-token paged step, the speculative verify's shape: T =
    draft_k + 1 new rows a slot written into their pages and all T
    positions evaluated causally in one forward.  step(params, pools, tokens
    (B, T), lengths (B,), tables (B, P), wpages (B, T), woffs (B, T), active
    (B,)) -> (logits (B, T, vocab), pools), every index a long tensor on the
    model's device.  Rejected drafts need no rollback: their rows sit past
    the slot's accepted length, masked by position, and the next tick
    rewrites the same (page, offset) rows.  The llama family runs its paged
    forward over T tokens; every other family the generic adapter over
    forward_fn."""
    from .models import llama

    if isinstance(model, llama.Llama):
        return _make_paged_llama_general(model, pcfg)
    if forward_fn is None:
        raise TypeError(f"the paged verify of {type(model).__name__} needs forward_fn for the generic adapter")
    return _make_paged_multi_generic(model, pcfg, forward_fn)


def _make_paged_multi_generic(model, pcfg: PagedConfig, forward_fn):
    """The generic multi-token paged step, by the composition of
    _make_paged_step_generic: each layer's window gathered into a dense
    view, the family's own forward over the T tokens, then the T rows each
    slot wrote scattered back into their pages.  The rows are read from the
    start the forward wrote them at: lengths clamped to [0, W - T], as JAX's
    dynamic_slice clamps it."""
    cfg = model.cfg

    def step(params, pools, tokens, lengths, tables, wpages, woffs, active):
        b, t = tokens.shape
        views = [(paged_gather(kp, tables), paged_gather(vp, tables)) for kp, vp in pools]
        logits, views = forward_fn(params, cfg, tokens, lengths, views, lengths)
        w = views[0][0].shape[2]
        rows = torch.arange(b, device=tokens.device)[:, None]
        cols = lengths.to(torch.long).clamp(0, w - t)[:, None] + torch.arange(t, device=tokens.device)[None, :]
        for (kp, vp), (kv, vv) in zip(pools, views):
            krows, vrows = kv[rows, :, cols], vv[rows, :, cols]  # (B, T, H, D)
            for j in range(t):  # T is small and static
                paged_write(kp, krows[:, j], wpages[:, j], woffs[:, j])
                paged_write(vp, vrows[:, j], wpages[:, j], woffs[:, j])
        return torch.where(active[:, None, None], logits, 0.0), pools

    return step


def _make_paged_step_generic(model, pcfg: PagedConfig, forward_fn):
    """Any dense-KV family paged, by composition: gather each layer's window
    into a dense per-layer cache, run the family's OWN forward over it (the
    program the dense engine serves, so paged equals dense by construction),
    then scatter the row each slot just wrote back into its page.  The views
    of all layers exist at once: peak memory approaches the pools plus one
    dense cache, so a wide model takes a specialized step."""
    cfg = model.cfg

    def step(params, pools, tokens, lengths, tables, wpage, woff, active):
        views = [(paged_gather(kp, tables), paged_gather(vp, tables)) for kp, vp in pools]
        logits, views = forward_fn(params, cfg, tokens, lengths, views, lengths)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        for (kp, vp), (kv, vv) in zip(pools, views):
            paged_write(kp, kv[rows, :, lengths], wpage, woff)
            paged_write(vp, vv[rows, :, lengths], wpage, woff)
        return torch.where(active[:, None], logits[:, -1], 0.0), pools

    return step


def _attend(q, kwin, vwin, positions, scale: float):
    """Grouped-query attention in f32 over gathered windows (the JAX paged
    steps' einsums): q (b, t, H, d), kwin and vwin (b, H_kv, W, d); query j of
    row b at positions[b, j] sees the window rows at or before it.  Returns
    (b, t, H * d) in vwin's type."""
    b, t, n_head, d = q.shape
    n_kv, w = kwin.shape[1], kwin.shape[2]
    rep = n_head // n_kv
    qg = q.transpose(1, 2).reshape(b, n_kv, rep * t, d).float()
    att = torch.matmul(qg, kwin.float().transpose(-1, -2)) * scale
    att = att.view(b, n_kv, rep, t, w)
    visible = torch.arange(w, device=q.device)[None, None, None, None, :] <= positions[:, None, None, :, None]
    att = torch.where(visible, att, torch.full((), float("-inf"), device=q.device))
    att = torch.softmax(att, dim=-1).to(vwin.dtype)
    out = torch.matmul(att.view(b, n_kv, rep * t, w), vwin)
    return out.view(b, n_head, t, d).transpose(1, 2).reshape(b, t, n_head * d)


def _make_paged_llama_general(model, pcfg: PagedConfig):
    """The llama family's paged forward over T >= 1 tokens a slot (T = 1 is
    the decode step): query j of slot b sits at position lengths[b] + j and
    attends the window rows at or before it.  GQA, qk_norm, NoPE layers,
    rope_interleaved, scaled RoPE, the granite multipliers and the experts
    (models/llama.ffn_block), as the dense forward has them (paged must
    equal dense)."""
    from .models.gptj import _rope_interleaved, rope_angles
    from .models.llama import _rms_norm, _rope_half, _rope_half_angles, ffn_block
    from .models.common import linear as _linear

    cfg = model.cfg
    hd, n_kv = cfg.head_dim, cfg.n_head_kv
    scale = cfg.attn_scale or 1.0 / np.sqrt(hd)
    res = (lambda y: y) if cfg.resid_scale == 1.0 else (lambda y: cfg.resid_scale * y)

    def step(params, pools, tokens, lengths, tables, wpage, woff, active):
        b, t = tokens.shape
        positions = lengths[:, None].to(torch.long) + torch.arange(t, device=tokens.device)[None, :]
        embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
        x = embd[tokens]
        if cfg.embd_scale != 1.0:
            x = x * cfg.embd_scale
        dt = x.dtype
        cos, sin = rope_angles(positions, hd, cfg.rope_base) if cfg.rope_interleaved else _rope_half_angles(
            positions, cfg)
        for i in range(cfg.n_layer):
            pre = f"blk.{i}."
            h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
            q = _linear(h, params[pre + "attn_q.weight"], params.get(pre + "attn_q.bias")).reshape(b, t, cfg.n_head, hd)
            k = _linear(h, params[pre + "attn_k.weight"], params.get(pre + "attn_k.bias")).reshape(b, t, n_kv, hd)
            v = _linear(h, params[pre + "attn_v.weight"], params.get(pre + "attn_v.bias")).reshape(b, t, n_kv, hd)
            if cfg.qk_norm:
                q = _rms_norm(q, params[pre + "attn_q_norm.weight"], cfg.rms_eps)
                k = _rms_norm(k, params[pre + "attn_k_norm.weight"], cfg.rms_eps)
            if not (cfg.nope_interval and (i + 1) % cfg.nope_interval == 0):
                if cfg.rope_interleaved:
                    q, k = _rope_interleaved(q, cos, sin, hd), _rope_interleaved(k, cos, sin, hd)
                else:
                    q, k = _rope_half(q, cos, sin), _rope_half(k, cos, sin)
            kp, vp = pools[i]
            for j in range(t):  # T is small and static
                paged_write(kp, k[:, j], wpage[:, j], woff[:, j])
                paged_write(vp, v[:, j], wpage[:, j], woff[:, j])
            attn_out = _attend(q, paged_gather(kp, tables), paged_gather(vp, tables), positions, scale)
            x = x + res(_linear(attn_out.to(dt), params[pre + "attn_output.weight"]))
            x = x + res(ffn_block(params, pre, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps), cfg))
        x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
        w_out = params.get("output.weight", params.get("token_embd.weight@dense", params["token_embd.weight"]))
        logits = _linear(x, w_out)
        if cfg.logit_scale != 1.0:
            logits = logits / cfg.logit_scale
        return torch.where(active[:, None, None], logits, 0.0), pools

    return step


def _make_paged_step_gptj(model, pcfg: PagedConfig):
    """GPT-J's paged step: MHA, the interleaved (or, after the load's q/k
    permutation, deinterleaved) RoPE, the parallel residual, and the fused
    attn_qkvup projection split into q, k, v and ffn_up."""
    from .models.common import layer_norm as _layer_norm, linear as _linear
    from .models.gptj import _rope_deinterleaved, _rope_interleaved, rope_angles

    cfg = model.cfg
    rope = _rope_deinterleaved if cfg.rope_deinterleaved else _rope_interleaved
    scale = 1.0 / np.sqrt(cfg.head_dim)
    E, H, hd = cfg.n_embd, cfg.n_head, cfg.head_dim

    def step(params, pools, tokens, lengths, tables, wpage, woff, active):
        b, t = tokens.shape
        assert t == 1
        positions = lengths[:, None].to(torch.long)
        embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
        x = embd[tokens]
        dt = x.dtype
        cos, sin = rope_angles(positions, cfg.n_rot)
        for i in range(cfg.n_layer):
            pre = f"blk.{i}."
            h = _layer_norm(x, params[pre + "attn_norm.weight"], params[pre + "attn_norm.bias"], cfg.eps)
            ff_pre = None
            if pre + "attn_qkvup.weight" in params:
                q, k, v, ff_pre = torch.split(_linear(h, params[pre + "attn_qkvup.weight"]), [E, E, E, 4 * E], dim=-1)
            else:
                q = _linear(h, params[pre + "attn_q.weight"])
                k = _linear(h, params[pre + "attn_k.weight"])
                v = _linear(h, params[pre + "attn_v.weight"])
            q = rope(q.reshape(b, 1, H, hd), cos, sin, cfg.n_rot)
            k = rope(k.reshape(b, 1, H, hd), cos, sin, cfg.n_rot)
            kp, vp = pools[i]
            paged_write(kp, k[:, 0], wpage, woff)
            paged_write(vp, v.reshape(b, H, hd), wpage, woff)
            attn_out = _attend(q, paged_gather(kp, tables), paged_gather(vp, tables), positions, scale)
            attn_out = _linear(attn_out.to(dt), params[pre + "attn_output.weight"])
            if ff_pre is not None:
                ff = ff_pre + params[pre + "ffn_up.bias"]
            else:
                ff = _linear(h, params[pre + "ffn_up.weight"], params[pre + "ffn_up.bias"])
            ff = 0.5 * ff * (1.0 + torch.tanh(0.79788456080286535588 * ff * (1.0 + 0.044715 * ff * ff)))
            ff = _linear(ff, params[pre + "ffn_down.weight"], params[pre + "ffn_down.bias"])
            x = x + attn_out + ff
        x = _layer_norm(x, params["output_norm.weight"], params["output_norm.bias"], cfg.eps)
        logits = _linear(x, params["output.weight"], params.get("output.bias"))[:, 0]
        return torch.where(active[:, None], logits, 0.0), pools

    return step


def _make_paged_step_gemma2(model, pcfg: PagedConfig):
    """The gemma family's paged step (paged_kv.py:635-722): the f32 scaled
    embedding, the sandwich norms, both softcaps, each layer's sliding or
    global window with its RoPE base and position scale, gemma3's q/k norms,
    as models/gemma2.forward has them (paged must equal dense).  The two keep
    masks over the gathered window are computed once a step."""
    from .models.common import gqa_attention, window_keep
    from .models.gemma2 import _rms_norm_gemma, attention_inputs, block_tail, embed, final_logits, layer_rope

    cfg = model.cfg
    scale = cfg.query_pre_attn_scalar ** -0.5
    window = pcfg.max_pages_per_seq * pcfg.page_size

    def step(params, pools, tokens, lengths, tables, wpage, woff, active):
        b, t = tokens.shape
        assert t == 1
        positions = lengths[:, None].to(torch.long)
        x = embed(params, cfg, tokens)
        dt = x.dtype
        keep = window_keep(positions, window)
        keep_sliding = window_keep(positions, window, cfg.sliding_window) if cfg.sliding_window else keep
        for i in range(cfg.n_layer):
            pre = f"blk.{i}."
            sliding, cos, sin = layer_rope(cfg, i, positions)
            q, k, v = attention_inputs(params, pre, _rms_norm_gemma(x, params[pre + "attn_norm.weight"], cfg.rms_eps),
                                       cos, sin, cfg)
            kp, vp = pools[i]
            paged_write(kp, k[:, 0], wpage, woff)
            paged_write(vp, v[:, 0], wpage, woff)
            out = gqa_attention(q.transpose(1, 2), paged_gather(kp, tables), paged_gather(vp, tables),
                                keep_sliding if sliding else keep, scale, softcap=cfg.attn_softcap)
            x = block_tail(params, pre, x, out.to(dt), cfg)
        return torch.where(active[:, None], final_logits(params, x, cfg)[:, 0], 0.0), pools

    return step


def _make_paged_step_phi3(model, pcfg: PagedConfig):
    """Phi-3's paged step (paged_kv.py:724-800): LongRoPE with the long or
    short factors chosen by the paged window's length (P x page_size rows,
    the length of the cache the step attends, as the dense forward chooses
    by its cache's), attn_factor on cos and sin, the uniform sliding window,
    as models/phi3.forward has them (paged must equal dense)."""
    from .models.common import gqa_attention, linear as _linear, window_keep
    from .models.llama import _rms_norm, _rope_half
    from .models.phi3 import mlp, rope_for

    cfg = model.cfg
    hd = cfg.head_dim
    window = pcfg.max_pages_per_seq * pcfg.page_size

    def step(params, pools, tokens, lengths, tables, wpage, woff, active):
        b, t = tokens.shape
        assert t == 1
        positions = lengths[:, None].to(torch.long)
        embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
        x = embd[tokens]
        dt = x.dtype
        cos, sin = rope_for(params, cfg, positions, window)
        keep = window_keep(positions, window, cfg.sliding_window)
        for i in range(cfg.n_layer):
            pre = f"blk.{i}."
            h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
            q = _linear(h, params[pre + "attn_q.weight"]).reshape(b, 1, cfg.n_head, hd)
            k = _linear(h, params[pre + "attn_k.weight"]).reshape(b, 1, cfg.n_head_kv, hd)
            v = _linear(h, params[pre + "attn_v.weight"]).reshape(b, cfg.n_head_kv, hd)
            kp, vp = pools[i]
            paged_write(kp, _rope_half(k, cos, sin)[:, 0], wpage, woff)
            paged_write(vp, v, wpage, woff)
            out = gqa_attention(_rope_half(q, cos, sin).transpose(1, 2), paged_gather(kp, tables),
                                paged_gather(vp, tables), keep, hd ** -0.5)
            x = x + _linear(out.to(dt), params[pre + "attn_output.weight"])
            x = x + mlp(params, pre, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps))
        x = _rms_norm(x, params["output_norm.weight"], cfg.rms_eps)
        logits = _linear(x, params.get("output.weight", params["token_embd.weight"]))[:, 0]
        return torch.where(active[:, None], logits, 0.0), pools

    return step


def _make_paged_step_deepseek(model, pcfg: PagedConfig):
    """DeepSeek's absorbed-MLA paged step (paged_kv.py:802-891): the pools
    hold each token's latent and rope key, written at (wpage, woff), and
    every slot attends over its gathered window as the dense forward
    attends over its cache (paged equals dense).  The head is the file's
    output, or the embedding's dense copy, as JAX's step takes it."""
    from .models.deepseek import attention_inputs, ffn_block, final_logits, mla_attention
    from .models.gptj import rope_angles
    from .models.common import linear as _linear
    from .models.llama import _rms_norm

    cfg = model.cfg
    window = pcfg.max_pages_per_seq * pcfg.page_size

    def step(params, pools, tokens, lengths, tables, wpage, woff, active):
        b, t = tokens.shape
        assert t == 1
        positions = lengths[:, None].to(torch.long)
        embd = params.get("token_embd.weight@dense", params["token_embd.weight"])
        x = embd[tokens]
        dt = x.dtype
        cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_base)
        visible = torch.arange(window, device=tokens.device)[None, None, None, :] <= positions[:, :, None, None]
        for i in range(cfg.n_layer):
            pre = f"blk.{i}."
            h = _rms_norm(x, params[pre + "attn_norm.weight"], cfg.rms_eps)
            q_pass, q_rot, c_t, krot = attention_inputs(params, pre, h, cos, sin, cfg)
            cp, kp = pools[i]
            paged_write(cp, c_t, wpage, woff)  # (B, 1, rank): one head
            paged_write(kp, krot, wpage, woff)
            with torch.profiler.record_function("deepseek.attention"):
                o = mla_attention(q_pass, q_rot, paged_gather(cp, tables)[:, 0], paged_gather(kp, tables)[:, 0],
                                  params[pre + "attn_kv_b.weight"], visible, cfg, dt)
            x = x + _linear(o, params[pre + "attn_output.weight"])
            x = x + ffn_block(params, pre, i, _rms_norm(x, params[pre + "ffn_norm.weight"], cfg.rms_eps), cfg)
        w_out = params.get("output.weight", params.get("token_embd.weight@dense", params["token_embd.weight"]))
        logits = final_logits(params, x, cfg, w_out)[:, 0]
        return torch.where(active[:, None], logits, 0.0), pools

    return step


class PagedDecodeScan:
    """The paged stretch (JAX's make_paged_decode_scan, a jitted lax.scan):
    h greedy steps of a paged step over the pools, the page-table rows and
    the write coordinates of all h positions computed on the host first
    (PagedKVManager.step_coords_multi after ensure_capacity).  Slots that
    stop mid-stretch keep writing rows past their final length, which no
    query reads (position-masked) and the next tick rewrites.

    On the card the h steps are ONE CUDA graph replay over static (tokens,
    lengths, tables, wpages, woffs, active) buffers that the host fills by
    copy_ through pinned memory before each replay; one capture per h, all
    graphs sharing one memory pool.  The capture's warm-up runs the same
    steps on a side stream (it writes the rows the replay rewrites with the
    same values); its launch counts move to the replays, as the engine's
    decode graphs do.  On the CPU the steps run eagerly."""

    def __init__(self, step_fn, max_batch: int, max_pages: int, max_h: int, device):
        self.step_fn = step_fn
        dev = self.device = torch.device(device)
        B = max_batch
        self.tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.lengths = torch.zeros((B,), dtype=torch.long, device=dev)
        self.tables = torch.zeros((B, max_pages), dtype=torch.long, device=dev)
        self.wpages = torch.zeros((max_h, B), dtype=torch.long, device=dev)
        self.woffs = torch.zeros((max_h, B), dtype=torch.long, device=dev)
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.outs = torch.zeros((max_h, B), dtype=torch.long, device=dev)
        self._cur_tok = torch.zeros_like(self.tok)  # the carry, set from tok and lengths in the graph
        self._cur_len = torch.zeros_like(self.lengths)
        self.graphs: dict = {}  # h -> (CUDAGraph, launches of its h steps per table)
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.stretches = 0  # calls: graph replays on the card, eager runs on the CPU
        self.steps = 0  # decode steps inside them

    def _steps(self, params, pools, h: int):
        self._cur_tok.copy_(self.tok)
        self._cur_len.copy_(self.lengths)
        for j in range(h):
            logits, _ = self.step_fn(params, pools, self._cur_tok, self._cur_len, self.tables, self.wpages[j],
                                     self.woffs[j], self.active)
            nxt = torch.where(self.active, torch.argmax(logits, dim=-1), 0)
            self.outs[j].copy_(nxt)
            self._cur_len += self.active.to(torch.long)
            self._cur_tok.copy_(nxt[:, None])

    def _capture(self, params, pools, h: int):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self.captures += 1
        return capture_graph(lambda: self._steps(params, pools, h), self.device, pool=self._pool)

    def __call__(self, params, pools, tok, lengths, tables, wpages, woffs, active, h: int, *, put,
                 span) -> np.ndarray:
        """Host arrays tok (B, 1), lengths (B,), tables (B, P), wpages and
        woffs (B, h), active (B,) -> the (h, B) greedy ids on the host.
        put(buffer, values): the caller's host-to-device writer (pinned,
        asynchronous: serve.Engine._put); span(kind): a context manager
        around the replay (serve.Engine._span)."""
        put(self.tok, tok)
        put(self.lengths, lengths)
        put(self.tables, tables)
        put(self.wpages[:h], np.asarray(wpages).T)
        put(self.woffs[:h], np.asarray(woffs).T)
        put(self.active, active)
        self.stretches += 1
        self.steps += h
        with torch.no_grad():
            if self.device.type != "cuda":
                self._steps(params, pools, h)
                return self.outs[:h].numpy().copy()
            if h not in self.graphs:
                self.graphs[h] = self._capture(params, pools, h)
            graph, per_call = self.graphs[h]
            with span("paged"):
                graph.replay()
        count_replays(per_call)
        self.replays += 1
        return self.outs[:h].cpu().numpy()


def make_paged_decode_scan(step_fn, max_batch: int, max_pages: int, max_h: int, device) -> PagedDecodeScan:
    """The multi-step paged decode of a single-token paged step: a callable
    scan(params, pools, tok, lengths, tables, wpages, woffs, active, h, *,
    put, span) -> (h, B) ids (see PagedDecodeScan)."""
    return PagedDecodeScan(step_fn, max_batch, max_pages, max_h, device)
