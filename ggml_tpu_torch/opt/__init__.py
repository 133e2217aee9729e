"""Training — the port of ggml_tpu/opt (the ggml-opt analog): the shard-
shuffled Dataset, the losses, the AdamW Optimizer, the epoch/fit loops
(MNIST), LM finetuning with rematerialization, and LoRA / QLoRA finetuning
(optimizer checkpoints: ggml_tpu_torch/checkpoint.py).

Not ported yet (ROADMAP.md): the data-parallel mesh.
"""

from .dataset import Dataset  # noqa: F401
from .optimizer import LOSS_TYPES, AdamWConfig, Optimizer  # noqa: F401
from .fit import Result, epoch, fit  # noqa: F401
from .finetune import finetune, make_lm_model_fn, save_params_gguf, token_windows  # noqa: F401
from .lora import (  # noqa: F401
    apply_lora_to_params, finetune_lora, init_lora, load_lora_gguf, merge_lora, save_lora_gguf,
)
