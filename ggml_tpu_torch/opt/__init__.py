"""Training — the port of ggml_tpu/opt (the ggml-opt analog): the shard-
shuffled Dataset, the losses, the AdamW Optimizer, LM finetuning and LoRA /
QLoRA finetuning (optimizer checkpoints: ggml_tpu_torch/checkpoint.py).

Not ported yet (ROADMAP.md): fit/epoch (MNIST), remat, the data-parallel mesh.
"""

from .dataset import Dataset  # noqa: F401
from .finetune import finetune, make_lm_model_fn, save_params_gguf, token_windows  # noqa: F401
from .lora import finetune_lora  # noqa: F401
from .optimizer import LOSS_TYPES, AdamWConfig, Optimizer  # noqa: F401
