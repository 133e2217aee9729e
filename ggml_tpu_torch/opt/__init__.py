"""Training — the port of ggml_tpu/opt (the ggml-opt analog): the shard-
shuffled Dataset, the losses, the AdamW Optimizer and LM finetuning.

Not ported yet (ROADMAP.md): fit/epoch (MNIST), LoRA and QLoRA, optimizer
checkpoints, remat, the data-parallel mesh.
"""

from .dataset import Dataset  # noqa: F401
from .finetune import finetune, make_lm_model_fn, save_params_gguf, token_windows  # noqa: F401
from .optimizer import LOSS_TYPES, AdamWConfig, Optimizer  # noqa: F401
