"""Epoch and fit training loops with metrics that carry their uncertainty
(port of ggml_tpu/opt/fit.py).

Reference: ggml_opt_epoch (src/ggml-opt.cpp:677-766: train on the first
idata_split data points, evaluate on the rest, callbacks after each batch
with a progress bar) and ggml_opt_fit (src/ggml-opt.cpp:779-854: epochs,
val_split, silent).  The metrics follow ggml_opt_result_loss and _accuracy
(src/ggml-opt.cpp:531-581): the loss as mean +- stderr, the accuracy +-
its binomial stderr.  Shuffles draw from numpy, so the batches are the JAX
package's.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .dataset import Dataset
from .optimizer import Optimizer


class Result:
    """Per-batch metrics, accumulated (the ggml_opt_result analog).  A
    batch's loss and correct count are read back to the host as it lands."""

    def __init__(self):
        self.losses: list[float] = []
        self.ncorrect = 0
        self.npred = 0

    def update(self, metrics) -> None:
        self.losses.append(float(metrics["loss"]))
        n = int(metrics["n"])
        if n:
            self.ncorrect += int(metrics["ncorrect"])
            self.npred += n

    def loss(self) -> tuple[float, float]:
        """mean +- stderr (ggml_opt_result_loss, src/ggml-opt.cpp:531)."""
        if not self.losses:
            return float("nan"), float("nan")
        a = np.asarray(self.losses, np.float64)
        unc = a.std(ddof=1) / np.sqrt(len(a)) if len(a) > 1 else float("nan")
        return float(a.mean()), float(unc)

    def accuracy(self) -> tuple[float, float]:
        """fraction +- binomial stderr (src/ggml-opt.cpp:566-581)."""
        if self.npred == 0:
            return float("nan"), float("nan")
        p = self.ncorrect / self.npred
        unc = np.sqrt(p * (1.0 - p) / (self.npred - 1)) if self.npred > 1 else float("nan")
        return float(p), float(unc)


def _progress(prefix: str, ibatch: int, nbatches: int, result: Result, t0: float, file):
    loss, loss_unc = result.loss()
    acc, acc_unc = result.accuracy()
    bar_n = 8
    filled = (ibatch + 1) * bar_n // max(1, nbatches)
    bar = "=" * filled + ">" + "-" * (bar_n - filled)
    msg = f"\r{prefix}[{bar}] loss={loss:.5f}+-{loss_unc:.5f}"
    if result.npred:
        msg += f" acc={100 * acc:.2f}+-{100 * acc_unc:.2f}%"
    msg += f" t={time.time() - t0:.1f}s "
    print(msg, end="", file=file, flush=True)
    if ibatch + 1 == nbatches:
        print(file=file)


def epoch(opt: Optimizer, dataset: Dataset, batch_size: int, idata_split: int | None = None, callback_train=None,
          callback_eval=None, abort_callback=None) -> tuple[Result, Result]:
    """Train on batches [0, idata_split), evaluate on the rest (ggml_opt_epoch,
    include/ggml-opt.h:181-196).  abort_callback: asked between batches;
    True stops the epoch (the ggml_abort_callback analog)."""
    ndata = dataset.ndata
    if idata_split is None:
        idata_split = ndata
    if idata_split % batch_size:
        raise ValueError(f"idata_split {idata_split} is not whole batches of {batch_size}")
    nbatches = ndata // batch_size
    split_batch = idata_split // batch_size

    res_train, res_eval = Result(), Result()
    t0 = time.time()
    for ib in range(nbatches):
        if abort_callback is not None and abort_callback():
            break
        x, y = dataset.get_batch(ib, batch_size)
        if ib < split_batch:
            res_train.update(opt.step(x, y))
            if callback_train:
                callback_train(ib, split_batch, res_train, t0)
        else:
            res_eval.update(opt.eval(x, y))
            if callback_eval:
                callback_eval(ib - split_batch, nbatches - split_batch, res_eval, t0)
    return res_train, res_eval


def fit(opt: Optimizer, dataset: Dataset, batch_size: int, epochs: int, val_split: float = 0.0,
        silent: bool = False, seed: int = 0, file=sys.stderr) -> tuple[Result, Result]:
    """ggml_opt_fit (include/ggml-opt.h:198-212, src/ggml-opt.cpp:779): the
    first epoch shuffles every data point once, later ones only the
    training part, so the validation tail stays the same points.  Returns
    the last epoch's (train, eval) results."""
    nbatches = dataset.ndata // batch_size
    idata_split = int((1.0 - val_split) * nbatches) * batch_size
    rng = np.random.default_rng(seed)

    res_train = res_eval = None
    for ep in range(1, epochs + 1):
        dataset.shuffle(rng, None if ep == 1 else idata_split)
        cb_t = cb_e = None
        if not silent:
            print(f"epoch {ep}/{epochs}:", file=file)
            cb_t = lambda i, n, r, t0: _progress("  train: ", i, n, r, t0, file)
            cb_e = lambda i, n, r, t0: _progress("  val:   ", i, n, r, t0, file)
        res_train, res_eval = epoch(opt, dataset, batch_size, idata_split, cb_t, cb_e)
    return res_train, res_eval
