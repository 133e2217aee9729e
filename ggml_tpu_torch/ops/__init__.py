"""Tensor operations of ggml_tpu/ops that the port's models call."""
