"""llama_pipeline_parallel_tpu_torch — the PyTorch/CUDA port of
llama_pipeline_parallel_tpu for NVIDIA Hopper (H100).

The layout mirrors the JAX package: a module's counterpart sits at the same
path. Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path is
a hand-written CUDA kernel under `csrc/`, built with nvcc at first use. This
package imports neither jax nor the JAX package. Entry points run on the card
unless the caller passes device="cpu".
"""
