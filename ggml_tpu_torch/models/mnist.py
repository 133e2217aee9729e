"""MNIST fc and cnn models in PyTorch: the training example of the
reference's ggml-opt (port of ggml_tpu/models/mnist.py).

Reference: examples/mnist/mnist-common.cpp — the fc variant (784 ->
relu(500) -> 10, :252-254, :318) and the cnn variant (2 x [3x3 conv with
padding 1, relu, 2x2 max pool] over NCB = 8 base channels, then a dense
layer, :334-357; hyperparameters examples/mnist/mnist-common.h:28-35).  Both
train with AdamW on the cross entropy through opt.fit, as the reference
calls ggml_opt_fit (examples/mnist/mnist-train.cpp:34-36).

Images are (batch, 28, 28) f32 in [0, 1]; logits (batch, 10).  The
parameters keep the JAX package's layouts (fc weights (in, out), conv
kernels HWIO, the cnn dense rows in an NHWC flatten), so init_fc and
init_cnn draw JAX's values bit for bit and save_gguf writes JAX's bytes;
cnn_forward runs torch's NCHW convolution and pooling (the JAX forward's
lax.conv_general_dilated and reduce_window are XLA ops, not Pallas kernels)
and flattens in NHWC order for the dense layer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HW = 28
NINPUT = HW * HW
NCLASSES = 10
NHIDDEN = 500
NCB = 8  # conv channel base


def _uniform(rng, shape, fan_in: int, device) -> torch.Tensor:
    """The reference init, uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn by
    numpy in the JAX package's order."""
    r = 1.0 / np.sqrt(fan_in)
    return torch.from_numpy(rng.uniform(-r, r, shape).astype(np.float32)).to(device)


def init_fc(seed: int = 0, device="cuda") -> dict:
    rng = np.random.default_rng(seed)
    return {
        "fc1_w": _uniform(rng, (NINPUT, NHIDDEN), NINPUT, device),
        "fc1_b": _uniform(rng, (NHIDDEN,), NINPUT, device),
        "fc2_w": _uniform(rng, (NHIDDEN, NCLASSES), NHIDDEN, device),
        "fc2_b": _uniform(rng, (NCLASSES,), NHIDDEN, device),
    }


def fc_forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    x = images.reshape(images.shape[0], NINPUT)
    h = torch.relu(x @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]


def init_cnn(seed: int = 0, device="cuda") -> dict:
    rng = np.random.default_rng(seed)
    s = HW // 4
    return {
        "conv1_k": _uniform(rng, (3, 3, 1, NCB), 3 * 3, device),  # HWIO
        "conv1_b": _uniform(rng, (NCB,), 3 * 3, device),
        "conv2_k": _uniform(rng, (3, 3, NCB, NCB * 2), 3 * 3 * NCB, device),
        "conv2_b": _uniform(rng, (NCB * 2,), 3 * 3 * NCB, device),
        "dense_w": _uniform(rng, (s * s * NCB * 2, NCLASSES), s * s * NCB * 2, device),
        "dense_b": _uniform(rng, (NCLASSES,), s * s * NCB * 2, device),
    }


def _conv_relu_pool(x, k_hwio, b):
    """3x3 convolution with padding 1 ("SAME"), bias, relu, 2x2 max pool, NCHW."""
    x = F.conv2d(x, k_hwio.permute(3, 2, 0, 1), padding=1)
    return F.max_pool2d(torch.relu(x + b[:, None, None]), 2)


def cnn_forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    x = images.reshape(images.shape[0], 1, HW, HW)  # NCHW
    x = _conv_relu_pool(x, params["conv1_k"], params["conv1_b"])
    x = _conv_relu_pool(x, params["conv2_k"], params["conv2_b"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the JAX forward's NHWC flatten
    return x @ params["dense_w"] + params["dense_b"]


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def save_gguf(params: dict, path, arch=None):
    """Write a reference-format mnist GGUF (the tensor names and layouts of
    examples/mnist/mnist-common.cpp:147-210: fc1.weight ne (784, 500), i.e.
    numpy (out, in); conv kernels OIHW; the cnn dense input dim in ggml's
    channel-major flatten order)."""
    from ..gguf import GGUFWriter

    w = GGUFWriter()
    is_fc = "fc1_w" in params
    p = {k: _numpy(v) for k, v in params.items()}
    w.add_string("general.architecture", arch or ("mnist-fc" if is_fc else "mnist-cnn"))
    if is_fc:
        w.add_tensor("fc1.weight", p["fc1_w"].T.copy())
        w.add_tensor("fc1.bias", p["fc1_b"])
        w.add_tensor("fc2.weight", p["fc2_w"].T.copy())
        w.add_tensor("fc2.bias", p["fc2_b"])
    else:
        w.add_tensor("conv1.kernel", p["conv1_k"].transpose(3, 2, 0, 1).copy())
        w.add_tensor("conv1.bias", p["conv1_b"].reshape(NCB, 1, 1))
        w.add_tensor("conv2.kernel", p["conv2_k"].transpose(3, 2, 0, 1).copy())
        w.add_tensor("conv2.bias", p["conv2_b"].reshape(NCB * 2, 1, 1))
        w.add_tensor("dense.weight", p["dense_w"][_cnn_flat_perm()].T.copy())  # rows in the NHWC flatten order
        w.add_tensor("dense.bias", p["dense_b"])
    w.write(path)
    return path


def _cnn_flat_perm() -> np.ndarray:
    """Index map from ggml's channel-major pooled-feature flatten (c, y, x) to
    the NHWC flatten (y, x, c): perm[ggml_index] = nhwc_index."""
    s = HW // 4
    idx = np.arange(s * s * NCB * 2).reshape(s, s, NCB * 2)  # (y, x, c) order
    return idx.transpose(2, 0, 1).reshape(-1)  # walked in (c, y, x) order


def load_gguf(path, device="cuda") -> dict:
    """Load a reference-format mnist GGUF (fc or cnn) into the parameter
    layout above, f32 on `device`."""
    from ..gguf import GGUFFile

    with GGUFFile(path) as g:
        arch = g.metadata.get("general.architecture", "mnist-fc")
        t = lambda name, *shape: g.to_float32(name).reshape(*shape)
        if arch == "mnist-fc":
            p = {"fc1_w": t("fc1.weight", NHIDDEN, NINPUT).T, "fc1_b": t("fc1.bias", NHIDDEN),
                 "fc2_w": t("fc2.weight", NCLASSES, NHIDDEN).T, "fc2_b": t("fc2.bias", NCLASSES)}
        else:
            s = HW // 4
            perm = _cnn_flat_perm()
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            p = {"conv1_k": t("conv1.kernel", NCB, 1, 3, 3).transpose(2, 3, 1, 0),
                 "conv1_b": t("conv1.bias", NCB),
                 "conv2_k": t("conv2.kernel", NCB * 2, NCB, 3, 3).transpose(2, 3, 1, 0),
                 "conv2_b": t("conv2.bias", NCB * 2),
                 "dense_w": t("dense.weight", NCLASSES, s * s * NCB * 2).T[inv],
                 "dense_b": t("dense.bias", NCLASSES)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in p.items()}


def synthetic_mnist(n: int, seed: int = 0):
    """A structured synthetic stand-in for the MNIST files (nothing is
    downloaded): each class a fixed smooth prototype plus noise, learnable
    to > 95 %.  Returns numpy (images (n, 28, 28) f32, one-hot labels (n,
    10) f32, labels (n,) int), JAX's draws bit for bit."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HW, 0:HW].astype(np.float32) / HW
    protos = []
    for c in range(NCLASSES):
        f1, f2 = 1 + c % 4, 1 + c // 4
        p = 0.5 + 0.5 * np.sin(2 * np.pi * f1 * xx + c) * np.cos(2 * np.pi * f2 * yy - c)
        protos.append(p.astype(np.float32))
    protos = np.stack(protos)
    labels = rng.integers(0, NCLASSES, n)
    images = protos[labels] + rng.normal(0, 0.35, (n, HW, HW)).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    onehot = np.eye(NCLASSES, dtype=np.float32)[labels]
    return images.astype(np.float32), onehot, labels
