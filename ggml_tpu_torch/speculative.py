"""Speculative decoding: draft-and-verify generation on the device (port of
ggml_tpu/speculative.py).

Each round the draft model decodes k tokens one at a time, the target runs
ONE forward over [current, d_1..d_k], and the emitted tokens are the longest
prefix of drafts that match the target's own greedy choices, plus the
target's correction.  Memory-bound quantized decode makes this a serving
lever: a (k+1)-token verify streams the same plane bytes as a one-token
step.  Greedy speculation emits what plain greedy decoding of the target
emits wherever the two forwards agree on the argmax; on the card the verify's
k+1 rows take other kernels than a one-token step (B or C against A), so
near-tied logits may part them.  The sampled decoder accepts a draft with
probability min(1, p/q) and draws the correction from norm(max(p - q, 0)):
its output is distributed as plain sampling from the warped target.

No cache rollback: a verify writes rows p..p+k before attending, so the
rejected rows lie past the accepted length, masked by position, and the
next round rewrites them before any query reads them.

The JAX package runs the rounds inside one jitted lax.while_loop.  Here a
round reads no value on the host (the draft's position is a 0-d tensor on
the device, acceptance is computed there, the draws come from an explicit
torch.Generator); on the card it is captured once as a CUDA graph over
static caches and state (count, position, token, the out buffer) and
replayed in groups, with one host read of the count a group.  A group never
holds more rounds than the fewest that can reach max_new, so no round runs
past it; a round that starts there anyway changes neither the out buffer
nor `rounds`.  On the CPU the same round runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.common import capture_graph, count_replays
from .sampling import race, warp_logits

SPEC_GROUP = 4  # graph replays (rounds) between two host reads of the count


def _forward_for(model):
    """The family forward of a model wrapper (JAX serve.py's dispatch)."""
    from .models import (dbrx, deepseek, falcon, gemma2, glm4moe, gpt2, gptj, gptoss, llama, neox, olmoe, phi2, phi3,
                         phimoe)

    for fam, cls in ((llama, llama.Llama), (deepseek, deepseek.Deepseek), (gptj, gptj.GPTJ), (gpt2, gpt2.GPT2),
                     (glm4moe, glm4moe.GLM4MoE), (olmoe, olmoe.OlmoE), (dbrx, dbrx.DBRX), (phimoe, phimoe.PhiMoE),
                     (gptoss, gptoss.GptOss), (gemma2, gemma2.Gemma2), (phi2, phi2.Phi2), (phi3, phi3.Phi3),
                     (neox, neox.NeoX), (falcon, falcon.Falcon)):
        if isinstance(model, cls):
            return fam.forward
    raise TypeError(f"no forward for {type(model).__name__}")


class _State:
    """The round's carry on the device: the token fed next (1, 1), its
    position (0-d int32, which the decode attention kernel reads itself),
    the tokens emitted (0-d), the rounds run (0-d), the out buffer
    (max_new + k + 1,), whose slack takes the last round's block, and the
    drafts each round accepted (max_new + 1,)."""

    def __init__(self, max_new: int, k: int, device):
        self.tok = torch.zeros((1, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)
        self.count = torch.zeros((), dtype=torch.long, device=device)
        self.rounds = torch.zeros((), dtype=torch.long, device=device)
        self.out = torch.zeros((max_new + k + 1,), dtype=torch.long, device=device)
        self.accepted = torch.zeros((max_new + 1,), dtype=torch.long, device=device)

    def start(self, first_token, n_past: int):
        self.tok.copy_(torch.as_tensor(first_token).reshape(1, 1))
        self.pos.fill_(n_past)
        self.count.zero_()
        self.rounds.zero_()
        self.out.zero_()
        self.accepted.zero_()

    def buffers(self):
        return (self.tok, self.pos, self.count, self.rounds, self.out, self.accepted)


class SpeculativeDecoder:
    """Draft-and-verify decode of one sequence (batch 1): decode(tcache,
    dcache, first_token, n_past[, generator]) -> (ids (max_new,) numpy,
    rounds, tcache, dcache[, generator]).  `rounds` counts the target
    forwards, as the JAX decoder's does.  sampler: warp_logits keyword
    arguments (temperature, top_k, top_p) for the sampled decoder, None for
    greedy; draft_sampler defaults to sampler.

    On the card the round is captured at the first call (one graph per cache
    signature) over static caches of the callers' shapes: a call copies its
    caches' rows before n_past in, replays, and copies the rows the rounds
    wrote back; the draws come from a
    generator registered with the graph, set to the caller's generator's
    state before the replays and copied back after.  The kernels' launch
    counters move as DecodeGraph's do: each replay adds its captured round's.
    After a call, `accepted` holds the drafts each round accepted."""

    def __init__(self, target, draft, k: int = 4, max_new: int = 64, sampler: dict | None = None,
                 draft_sampler: dict | None = None):
        if k < 1:
            raise ValueError(f"k = {k}: at least one draft token a round")
        if target.device != draft.device:
            raise ValueError(f"target on {target.device}, draft on {draft.device}")
        self.target, self.draft = target, draft
        self.tfwd, self.dfwd = _forward_for(target), _forward_for(draft)
        self.k, self.max_new = k, max_new
        self.device = target.device
        self.sampled = sampler is not None
        self.skw = dict(sampler or {})
        self.dkw = dict(draft_sampler if draft_sampler is not None else self.skw)
        self.state = None  # the carry and the graph's generator, made on the models' device at the first call
        self.generator = None
        self.accepted = np.zeros((0,), np.int64)
        self._static: dict = {}  # cache signature -> (target cache, draft cache, CUDAGraph, launches a round)
        self.captures = 0
        self.replays = 0

    # -- one round --------------------------------------------------------------

    def _round(self, tcache, dcache, gen):
        """One draft-and-verify round over the state and the caches, reading
        no value on the host."""
        st, k = self.state, self.k
        live = st.count < self.max_new
        verify = lambda seq, pos: self.tfwd(self.target.params, self.target.cfg, seq, pos.expand(1), tcache, pos)[0]
        block, n_acc, correction = spec_round(self.draft, self.dfwd, dcache, st.tok, st.pos, k, verify,
                                              (gen, self.skw, self.dkw) if self.sampled else None)
        block, n_acc, correction = block[0], n_acc[0], correction[0]
        idx = st.count.clamp(max=self.max_new) + torch.arange(k + 1, device=self.device)
        st.out.index_copy_(0, idx, torch.where(live, block, st.out[idx]))
        at = st.rounds.clamp(max=self.max_new).view(1)
        st.accepted.index_copy_(0, at, torch.where(live, n_acc, st.accepted[at]).view(1))
        adv = torch.where(live, n_acc + 1, 0)
        st.count += adv
        st.pos += adv.to(torch.int32)
        st.rounds += live.to(torch.long)
        st.tok.copy_(torch.where(live, correction, st.tok.view(())).view(1, 1))

    def _capture(self, tcache, dcache):
        """Capture one round over the static caches (models/common.
        capture_graph, the state and the generator restored after its
        warm-up: the rows it wrote at and past the position are rewritten by
        the real rounds before any query reads them)."""
        self.captures += 1
        return capture_graph(lambda: self._round(tcache, dcache, self.generator), self.device,
                             self.state.buffers(), self.generator if self.sampled else None)

    # -- decode ------------------------------------------------------------------

    def __call__(self, tcache, dcache, first_token, n_past: int, generator: torch.Generator | None = None, *,
                 graph: bool | None = None):
        """graph: replay the captured round (the default on the card; True
        on the CPU raises); False runs the rounds eagerly over the callers'
        caches, reading the count after each."""
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs models on the card, not on {self.device}")
        if self.sampled and generator is None:
            raise ValueError("the sampled decoder draws from a torch.Generator: pass one")
        n_past = int(n_past)
        for cache, what in ((tcache, "target"), (dcache, "draft")):
            rows = cache[0][0].shape[-2]
            if self.max_new and n_past + self.max_new + self.k > rows:
                raise ValueError(f"{what} cache of {rows} rows: the last round writes up to row "
                                 f"{n_past + self.max_new + self.k - 1}")
        if self.state is None:
            self.state = _State(self.max_new, self.k, self.device)
            self.generator = torch.Generator(device=self.device)
            # the sampler's floats as device scalars: a captured round reads
            # them, and a Python float would be copied to the card inside it
            scalar = lambda x: torch.tensor(float(x), dtype=torch.float32, device=self.device)
            for kw in (self.skw, self.dkw):
                kw.update({key: scalar(kw[key]) for key in ("temperature", "top_p") if key in kw})
        st = self.state
        with torch.no_grad():
            st.start(first_token, n_past)
            if not graph:
                while int(st.count) < self.max_new:
                    self._round(tcache, dcache, generator)
            else:
                self._run_graphed(tcache, dcache, generator, n_past)
            ids = st.out[:self.max_new].cpu().numpy().copy()
            rounds = int(st.rounds)
            self.accepted = st.accepted[:rounds].cpu().numpy().copy()
        out = (ids, rounds, tcache, dcache)
        return out + (generator,) if self.sampled else out

    def _run_graphed(self, tcache, dcache, generator, n_past: int):
        """The rounds as graph replays over the static caches: the callers'
        rows [0, n_past) copied in, and the rows the rounds write, [n_past,
        n_past + max_new + k), copied back."""
        sig = tuple((c.shape, c.dtype) for layer in (*tcache, *dcache) for c in layer)
        if sig not in self._static:
            static = ([tuple(torch.zeros_like(c) for c in layer) for layer in tcache],
                      [tuple(torch.zeros_like(c) for c in layer) for layer in dcache])
            self._static[sig] = static + self._capture(*static)
        st_t, st_d, graph, per_round = self._static[sig]
        before, written = slice(0, n_past), slice(n_past, n_past + self.max_new + self.k)
        self._copy(tcache, st_t, before)
        self._copy(dcache, st_d, before)
        if self.sampled:
            self.generator.set_state(generator.get_state())
        count, replays = 0, 0
        while count < self.max_new:
            # the fewest rounds that can reach max_new: none of them starts past it
            for _ in range(min(SPEC_GROUP, -(-(self.max_new - count) // (self.k + 1)))):
                graph.replay()
                replays += 1
            count = int(self.state.count)
        if self.sampled:
            generator.set_state(self.generator.get_state())
        self.replays += replays
        count_replays(per_round, replays)
        self._copy(st_t, tcache, written)
        self._copy(st_d, dcache, written)

    @staticmethod
    def _copy(src, dst, rows: slice):
        for a, b in zip(src, dst):
            for x, y in zip(a, b):
                y[:, :, rows].copy_(x[:, :, rows])


def spec_round(draft, dfwd, dcache, tok, pos, k: int, verify, sampling=None):
    """One draft-and-verify round of b sequences, reading no value on the
    host (the decoder's at b = 1, the engine's over its slots): k draft
    steps from tok (b, 1) at pos (0-d, one position, which GPT-J's decode
    attention reads itself at b = 1; or (b,), one a sequence), greedy or
    drawn from the draft's warped distribution; the step that writes d_k's
    row, whose logits are not needed (without it a fully accepted round
    would leave a row of the draft cache that is never written);
    verify(seq (b, k + 1), pos) -> the target's logits (b, k + 1, V); the
    accept rule.  sampling: None (greedy) or (generator, the target's
    warp_logits keywords, the draft's).  Returns (block (b, k + 1), n_acc
    (b,), correction (b,))."""
    b = tok.shape[0]
    cur, drafts, q_rows = tok, [], []
    for j in range(k + 1):
        p = pos + j
        logits, _ = dfwd(draft.params, draft.cfg, cur, p.expand(b), dcache, p, need_logits=j < k)
        if j == k:
            break
        if sampling is not None:
            wl = warp_logits(logits[:, -1], **sampling[2])
            q_rows.append(torch.log_softmax(wl, dim=-1))
            nxt = race(wl, sampling[0])
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1)
        drafts.append(nxt)
        cur = nxt[:, None]
    drafts = torch.stack(drafts, dim=1)  # (b, k)
    tlogits = verify(torch.cat([tok, drafts], dim=1), pos)
    if sampling is not None:
        gen, target_kw, _ = sampling
        p_logp = torch.log_softmax(warp_logits(tlogits, **target_kw), dim=-1)
        n_acc, correction = _accept_sampled(drafts, torch.stack(q_rows, dim=1), p_logp, gen)
    else:
        n_acc, correction = _accept_greedy(drafts, torch.argmax(tlogits, dim=-1))
    return _block(drafts, n_acc, correction), n_acc, correction


def _accept_greedy(drafts: torch.Tensor, greedy: torch.Tensor):
    """drafts (b, k), the target's greedy ids (b, k + 1) -> (n_acc (b,), the
    correction (b,)): the longest prefix of drafts equal to the target's
    choices, and the target's id after it."""
    k = drafts.shape[1]
    n_acc = torch.cumprod((drafts == greedy[:, :k]).to(torch.long), dim=1).sum(dim=1)
    return n_acc, greedy.gather(1, n_acc[:, None])[:, 0]


def _accept_sampled(drafts: torch.Tensor, q_logp: torch.Tensor, p_logp: torch.Tensor, gen: torch.Generator):
    """Rejection sampling (ggml_tpu/speculative.py:149-197): drafts (b, k)
    drawn from the draft's warped log-probabilities q_logp (b, k, V), the
    target's p_logp (b, k + 1, V).  Accept d_i with probability min(1,
    p/q); the correction comes from norm(max(p - q, 0)) at the first
    rejection, or from p after the last draft when every draft is accepted
    (q := 0 there).  Returns (n_acc (b,), correction (b,))."""
    b, k = drafts.shape
    p_d = p_logp[:, :k].gather(2, drafts[..., None])[..., 0]
    q_d = q_logp.gather(2, drafts[..., None])[..., 0]
    u = torch.rand((b, k), generator=gen, device=drafts.device)
    n_acc = torch.cumprod((u < torch.exp(p_d - q_d)).to(torch.long), dim=1).sum(dim=1)
    p_row = p_logp.gather(1, n_acc[:, None, None].expand(b, 1, p_logp.shape[-1]))[:, 0]
    q_row = q_logp.gather(1, n_acc.clamp(max=k - 1)[:, None, None].expand(b, 1, q_logp.shape[-1]))[:, 0]
    q_row = torch.where((n_acc < k)[:, None], q_row, torch.full((), float("-inf"), device=drafts.device))
    residual = torch.clamp(torch.exp(p_row) - torch.exp(q_row), min=0.0)
    total = residual.sum(dim=-1, keepdim=True)
    # total is 0 only where p == q exactly at a rejection: draw from p then
    probs = torch.where(total > 1e-12, residual / torch.clamp(total, min=1e-12), torch.exp(p_row))
    return n_acc, race(torch.log(probs + 1e-30), gen)


def _block(drafts: torch.Tensor, n_acc: torch.Tensor, correction: torch.Tensor) -> torch.Tensor:
    """(b, k + 1) emitted blocks: the drafts with the correction at index
    n_acc; entries past it are junk that count never reaches."""
    b, k = drafts.shape
    block = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype, device=drafts.device)], dim=1)
    at = torch.arange(k + 1, device=drafts.device)[None, :] == n_acc[:, None]
    return torch.where(at, correction[:, None], block)


def make_speculative_decoder(target, draft, k: int = 4, max_new: int = 64) -> SpeculativeDecoder:
    """The greedy speculative decoder: decode(tcache, dcache, first_token,
    n_past) -> (ids (max_new,), rounds, tcache, dcache), the caches written
    in place and returned (JAX's donated caches come back anew).  target and
    draft: model wrappers (GPTJ, Llama, GPT2) of one vocabulary on one
    device; max_new / rounds is the tokens a target forward."""
    return SpeculativeDecoder(target, draft, k, max_new)


def make_speculative_decoder_sampled(target, draft, k: int = 4, max_new: int = 64, sampler: dict | None = None,
                                     draft_sampler: dict | None = None) -> SpeculativeDecoder:
    """The sampled speculative decoder (rejection sampling, lossless in
    distribution): decode(tcache, dcache, first_token, n_past, generator) ->
    (ids, rounds, tcache, dcache, generator), generator a torch.Generator on
    the models' device.  sampler: warp_logits keyword arguments; the
    target's warped distribution is the one reproduced."""
    return SpeculativeDecoder(target, draft, k, max_new, sampler=dict(sampler or {}), draft_sampler=draft_sampler)


def _prefill_both(target, draft, prompt_tokens):
    """Both models prefilled on the prompt (their default cache types, as
    plain generate uses); returns (last target logits (1, V), tcache,
    dcache, t)."""
    prompt = np.asarray(prompt_tokens, np.int64).reshape(1, -1)
    with torch.no_grad():
        tlog, tcache, t = target.prefill(target.new_cache(), prompt)
        _, dcache, _ = draft.prefill(draft.new_cache(), prompt)
    return tlog, tcache, dcache, t


def speculative_generate(target, draft, prompt_tokens, n_tokens: int, k: int = 4):
    """Greedy: prefill both models on the prompt, then the speculative loop.
    Returns (n_tokens ids, rounds + 1 for the prefill's first token)."""
    tlog, tcache, dcache, t = _prefill_both(target, draft, prompt_tokens)
    first = int(torch.argmax(tlog[0]))
    dec = make_speculative_decoder(target, draft, k=k, max_new=n_tokens - 1)
    toks, rounds, _, _ = dec(tcache, dcache, first, t)
    return [first] + [int(x) for x in toks], rounds + 1


def speculative_generate_sampled(target, draft, prompt_tokens, n_tokens: int, k: int = 4,
                                 sampler: dict | None = None, seed: int = 0):
    """Sampled: prefill both models, draw the first token from the warped
    target distribution, then the rejection-sampling loop; the draws from a
    torch.Generator seeded with `seed` on the models' device (JAX's
    PRNGKey(seed) draws another stream from the same distributions).
    Returns (n_tokens ids, rounds + 1)."""
    tlog, tcache, dcache, t = _prefill_both(target, draft, prompt_tokens)
    gen = torch.Generator(device=target.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        first = int(race(warp_logits(tlog, **(sampler or {})), gen)[0])
    dec = make_speculative_decoder_sampled(target, draft, k=k, max_new=n_tokens - 1, sampler=sampler)
    toks, rounds, _, _, _ = dec(tcache, dcache, first, t, gen)
    return [first] + [int(x) for x in toks], rounds + 1
