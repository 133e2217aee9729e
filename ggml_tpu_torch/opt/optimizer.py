"""Losses and the AdamW optimizer (port of ggml_tpu/opt/optimizer.py;
reference: ggml_opt_init / ggml_opt_eval_graph, src/ggml-opt.cpp:293-673).

A train step is the forward, autograd's backward, the gradient-accumulation
bookkeeping (opt_period) and the AdamW update with the JAX package's
formulas: bias correction 1 - beta^t in f32, mhat / (sqrt(vhat) + eps) +
wd * p, moments updated in f32 and rounded to state_dtype on store.  That is
not torch.optim.AdamW, which places eps and the decoupled decay elsewhere.
The state (params, m, v, g_acc, t, i_acc) lives on the parameters' device
and is updated in place (the JAX step donates it); t stays on the device, so
a step never waits for the host.  params is a dict of tensors, or of such
dicts (the JAX package takes any pytree; LoRA trains {weight name: {"a",
"b"}}), and m, v and g_acc keep its nesting.  Where the JAX step decides on the device
whether an accumulation period is complete, the port counts the micro-steps
on the host too and decides there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


def loss_mean(outputs, labels):
    return torch.mean(outputs.float())


def loss_sum(outputs, labels):
    return torch.sum(outputs.float())


def loss_mse(outputs, labels):
    d = outputs.float() - labels.float()
    return torch.mean(d * d)


def loss_cross_entropy(outputs, labels):
    """Soft-label cross entropy over the last axis, mean over rows."""
    logp = torch.log_softmax(outputs.float(), dim=-1)
    return torch.mean(-torch.sum(labels.float() * logp, dim=-1))


def loss_cross_entropy_sparse(outputs, labels):
    """Integer-label cross entropy (the LM next-token loss): outputs (..., V),
    labels (...) int."""
    logp = torch.log_softmax(outputs.float(), dim=-1)
    return torch.mean(-torch.gather(logp, -1, labels[..., None].long()))


class _CESparseFused(torch.autograd.Function):
    """nll = lse(logits) - logits[label], f32 inside the reductions; the
    backward keeps only the logits (their own type) and a per-row f32 lse and
    emits the gradient in the logits' type (JAX _ce_sparse_fused)."""

    @staticmethod
    def forward(ctx, logits, labels):
        xf = logits.float()
        m = torch.amax(xf, dim=-1, keepdim=True)
        lse = m + torch.log(torch.sum(torch.exp(xf - m), dim=-1, keepdim=True))
        idx = labels[..., None].long()
        loss = torch.mean(lse - torch.gather(xf, -1, idx))
        ctx.save_for_backward(logits, lse, idx)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx = ctx.saved_tensors
        probs = torch.exp(logits.float() - lse)
        # probs - onehot: subtracting 1 at the label alone is the same f32 arithmetic
        probs.scatter_add_(-1, idx, torch.full(idx.shape, -1.0, device=probs.device))
        return (probs * (g / idx.numel())).to(logits.dtype), None


def loss_cross_entropy_sparse_fused(outputs, labels):
    """Fused integer-label cross entropy: loss_cross_entropy_sparse's value,
    with no vocabulary-sized f32 tensor kept for the backward."""
    return _CESparseFused.apply(outputs, labels)


LOSS_TYPES: dict[str, Callable] = {
    "mean": loss_mean,
    "sum": loss_sum,
    "mse": loss_mse,
    "cross_entropy": loss_cross_entropy,
    "cross_entropy_sparse": loss_cross_entropy_sparse,
    "cross_entropy_sparse_fused": loss_cross_entropy_sparse_fused,
}


@dataclass(frozen=True)
class AdamWConfig:
    """The reference's defaults (ggml_opt_get_default_optimizer_params,
    src/ggml-opt.cpp:223-235).  state_dtype "bfloat16" stores m and v in
    bf16; their update still computes in f32 and rounds once on store."""

    alpha: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    wd: float = 0.0
    state_dtype: str = "float32"


def _adamw_apply(cfg: AdamWConfig, params: list, m: list, v: list, g: list, t: torch.Tensor):
    """One AdamW update of every tensor in place; t (0-d int32) += 1."""
    t.add_(1)
    tf = t.float()
    b1c = 1.0 - torch.pow(cfg.beta1, tf)  # 1 - beta1^t (reference: src/ggml-opt.cpp:598-609)
    b2c = 1.0 - torch.pow(cfg.beta2, tf)
    m32 = [x.float() for x in m]  # f32 moments: the state tensors themselves
    torch._foreach_mul_(m32, cfg.beta1)
    torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.beta1))
    v32 = [x.float() for x in v]
    torch._foreach_mul_(v32, cfg.beta2)
    torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.beta2), g))
    for state, new in zip(m + v, m32 + v32):
        if state.dtype != torch.float32:  # round on store; the update reads the stored moments
            state.copy_(new)
    # the same operations in the same order as mhat / (sqrt(vhat) + eps),
    # each written over its input: two temporaries the size of the
    # parameters, not four (a full-weight step's peak)
    step = torch._foreach_div([x.float() for x in m], b1c)  # mhat
    den = torch._foreach_div([x.float() for x in v], b2c)  # vhat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(step, den)
    del den
    p32 = [p.float() for p in params]
    if cfg.wd:
        torch._foreach_add_(step, torch._foreach_mul(p32, cfg.wd))
    torch._foreach_mul_(step, cfg.alpha)
    torch._foreach_sub_(p32, step)
    for p, new in zip(params, p32):
        if p.dtype != torch.float32:
            p.copy_(new)


def _leaves(tree: dict) -> list:
    """The tensors of a nested dict, depth first in insertion order."""
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class Optimizer:
    """Train and eval steps over a (nested) dict of parameter tensors.

    model_fn(params, inputs) -> outputs (logits for classification), or
    model_fn(params, inputs, frozen) where `frozen` holds tensors that are not
    trained (no optimizer state).  The optimizer keeps private copies of the
    parameters; step() updates them in place."""

    def __init__(self, model_fn: Callable, params: dict, loss_type: str = "cross_entropy",
                 adamw: AdamWConfig = AdamWConfig(), opt_period: int = 1, classify: bool = True,
                 mesh=None, frozen=None):
        if mesh is not None:
            raise NotImplementedError("multi-device training is not ported yet (ROADMAP.md, parallel/)")
        if adamw.state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"state_dtype {adamw.state_dtype!r}: float32 or bfloat16")
        if opt_period < 1:
            raise ValueError(f"opt_period {opt_period} < 1")
        self.model_fn = model_fn
        self.frozen = frozen
        self.loss_fn = LOSS_TYPES[loss_type]
        self.loss_type = loss_type
        self.cfg = adamw
        self.opt_period = int(opt_period)
        self.classify = classify
        params = _tree_map(lambda p: p.detach().clone(), params)
        self.device = _leaves(params)[0].device
        sdt = torch.bfloat16 if adamw.state_dtype == "bfloat16" else torch.float32
        self.state = {
            "params": params,
            "m": _tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params),
            "v": _tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params),
            # accumulated in f32 whatever the moments' type
            "g_acc": _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "t": torch.zeros((), dtype=torch.int32, device=self.device),  # optimizer steps taken
            "i_acc": torch.zeros((), dtype=torch.int32, device=self.device),  # position in opt_period
        }
        self._i_acc = 0  # the host's count of state["i_acc"]

    def _batch(self, x):
        if x is None:
            return None
        return x.to(self.device) if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(self.device)

    def _loss_and_metrics(self, params, inputs, labels):
        outputs = (self.model_fn(params, inputs) if self.frozen is None
                   else self.model_fn(params, inputs, self.frozen))
        loss = self.loss_fn(outputs, labels)
        if self.classify and labels is not None and outputs.dim() >= 2:
            pred = torch.argmax(outputs, dim=-1)
            truth = torch.argmax(labels, dim=-1) if labels.shape == outputs.shape else labels
            ncorrect, n = torch.sum(pred == truth), pred.numel()
        else:
            ncorrect, n = torch.zeros((), dtype=torch.int32, device=self.device), 0
        return loss, ncorrect, n

    def step(self, inputs, labels):
        """One forward and backward (and a parameter update every opt_period
        calls).  Returns {'loss': 0-d tensor, 'ncorrect': 0-d tensor, 'n': int}."""
        inputs, labels = self._batch(inputs), self._batch(labels)
        st = self.state
        leaves = _tree_map(lambda p: p.detach().requires_grad_(True), st["params"])
        loss, ncorrect, n = self._loss_and_metrics(leaves, inputs, labels)
        flat = _leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float() for p, g in zip(flat, grads)]
        pick = lambda name: _leaves(st[name])
        if self.opt_period == 1:
            _adamw_apply(self.cfg, pick("params"), pick("m"), pick("v"), grads, st["t"])
        else:
            g_acc = pick("g_acc")
            torch._foreach_add_(g_acc, torch._foreach_div(grads, float(self.opt_period)))
            st["i_acc"].add_(1)
            self._i_acc += 1
            if self._i_acc >= self.opt_period:
                _adamw_apply(self.cfg, pick("params"), pick("m"), pick("v"), g_acc, st["t"])
                torch._foreach_zero_(g_acc)
                st["i_acc"].zero_()
                self._i_acc = 0
        return {"loss": loss.detach(), "ncorrect": ncorrect, "n": n}

    @torch.no_grad()
    def eval(self, inputs, labels):
        loss, ncorrect, n = self._loss_and_metrics(self.state["params"], self._batch(inputs), self._batch(labels))
        return {"loss": loss, "ncorrect": ncorrect, "n": n}

    @property
    def params(self) -> dict:
        return self.state["params"]

    def state_dict(self) -> dict:
        """The full optimizer state: params, m, v, g_acc (dicts of tensors,
        nested as params), t and i_acc (0-d int32 tensors)."""
        return self.state

    def load_state_dict(self, state: dict):
        self.state = state
        self._i_acc = int(state["i_acc"])
