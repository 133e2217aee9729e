"""Command-line entry points of the port (python -m ggml_tpu_torch.cli.<name>)."""
