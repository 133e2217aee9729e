"""The MNIST models and the fit loop of the port (ggml_tpu_torch.models.mnist,
ggml_tpu_torch.opt.fit) against the JAX package's, on the CPU.

- init_fc and init_cnn: JAX's parameters bit for bit (the same numpy
  draws); synthetic_mnist: JAX's images and labels bit for bit.
- fc_forward and cnn_forward (torch's NCHW convolution and pooling, the
  NHWC flatten) against JAX's on the same parameters: NMSE <= 1e-12 (f32
  sums in another order).
- save_gguf writes JAX's bytes, and each package's file loads in the other
  to the same parameters bit for bit.
- fit over 512 synthetic images, batch 64, val_split 0.125, 2 epochs at lr
  1e-3 (fc) and 3e-3 (cnn), against JAX's fit: the same permutation after
  both epochs (the same batches), every batch's loss within 1e-5, the
  validation loss within 1e-5 and the same correct count (f32 sums in
  another order, amplified by AdamW's normalization; they read 1.8e-7
  and 4.8e-7, and the validation loss 0).
- Result's mean +- stderr and binomial accuracy against JAX's; epoch's
  abort callback and its split check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_tpu.models import mnist as jmnist
from ggml_tpu.opt import AdamWConfig as JaxAdamWConfig
from ggml_tpu.opt import Dataset as JaxDataset
from ggml_tpu.opt import Optimizer as JaxOptimizer
from ggml_tpu.opt import fit as jax_fit
from ggml_tpu.opt.fit import Result as JaxResult
from ggml_tpu_torch.models import mnist
from ggml_tpu_torch.opt import AdamWConfig, Dataset, Optimizer, Result, epoch, fit
from tests.test_torch_rules import nmse

KINDS = {"fc": (mnist.init_fc, mnist.fc_forward, jmnist.init_fc, jmnist.fc_forward, 1e-3),
         "cnn": (mnist.init_cnn, mnist.cnn_forward, jmnist.init_cnn, jmnist.cnn_forward, 3e-3)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_init_and_forward_match_jax(kind):
    init, fwd, jinit, jfwd, _ = KINDS[kind]
    got, want = init(3, device="cpu"), jinit(3)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    images = np.random.default_rng(0).random((16, 28, 28)).astype(np.float32)
    logits = fwd(got, torch.from_numpy(images))
    assert logits.shape == (16, 10) and nmse(np.asarray(jfwd(want, jnp.asarray(images))), logits.numpy()) <= 1e-12


def test_synthetic_mnist_is_jax_s():
    for got, want in zip(mnist.synthetic_mnist(64, seed=1), jmnist.synthetic_mnist(64, seed=1)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_gguf_is_jax_s_both_ways(kind, tmp_path):
    init, _, jinit, _, _ = KINDS[kind]
    params = init(5, device="cpu")
    mnist.save_gguf(params, tmp_path / "port.gguf")
    jmnist.save_gguf(jinit(5), str(tmp_path / "jax.gguf"))
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    from_jax = mnist.load_gguf(tmp_path / "jax.gguf", device="cpu")
    from_port = jmnist.load_gguf(str(tmp_path / "port.gguf"))
    for name, p in params.items():
        assert torch.equal(from_jax[name], p), name
        np.testing.assert_array_equal(np.asarray(from_port[name]), p.numpy(), err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fit_matches_jax(kind):
    init, fwd, jinit, jfwd, lr = KINDS[kind]
    images, onehot, _ = mnist.synthetic_mnist(512, seed=1)
    jds, ds = JaxDataset(images, onehot), Dataset(images, onehot)
    jopt = JaxOptimizer(jfwd, jinit(0), loss_type="cross_entropy", adamw=JaxAdamWConfig(alpha=lr))
    opt = Optimizer(fwd, init(0, device="cpu"), loss_type="cross_entropy", adamw=AdamWConfig(alpha=lr))
    want = jax_fit(jopt, jds, batch_size=64, epochs=2, val_split=0.125, silent=True)
    got = fit(opt, ds, batch_size=64, epochs=2, val_split=0.125, silent=True)
    np.testing.assert_array_equal(ds.perm, jds.perm)
    (jtrain, jeval), (train, ev) = want, got
    assert len(train.losses) == len(jtrain.losses) == 7 and len(ev.losses) == 1
    assert np.abs(np.array(train.losses) - np.array(jtrain.losses)).max() <= 1e-5
    assert abs(ev.loss()[0] - jeval.loss()[0]) <= 1e-5
    assert (ev.ncorrect, ev.npred) == (jeval.ncorrect, jeval.npred) and ev.npred == 64
    assert train.losses[-1] < train.losses[0]


def test_result_and_epoch():
    metrics = [dict(loss=torch.tensor(v), ncorrect=torch.tensor(c), n=8) for v, c in ((2.0, 3), (1.5, 5), (1.0, 8))]
    res, jres = Result(), JaxResult()
    for m in metrics:
        res.update(m)
        jres.update(dict(loss=float(m["loss"]), ncorrect=int(m["ncorrect"]), n=8))
    assert res.loss() == pytest.approx(jres.loss(), rel=1e-12)
    assert res.accuracy() == pytest.approx(jres.accuracy(), rel=1e-12) and res.accuracy()[0] == 16 / 24
    assert all(np.isnan(v) for v in Result().loss() + Result().accuracy())

    images, onehot, _ = mnist.synthetic_mnist(64, seed=2)
    opt = Optimizer(mnist.fc_forward, mnist.init_fc(0, device="cpu"), loss_type="cross_entropy")
    calls = []
    train, ev = epoch(opt, Dataset(images, onehot), 16, idata_split=48,
                      callback_train=lambda *a: calls.append("t"), callback_eval=lambda *a: calls.append("e"),
                      abort_callback=lambda: len(calls) == 3)
    assert calls == ["t", "t", "t"] and len(train.losses) == 3 and not ev.losses
    with pytest.raises(ValueError, match="whole batches"):
        epoch(opt, Dataset(images, onehot), 16, idata_split=40)
