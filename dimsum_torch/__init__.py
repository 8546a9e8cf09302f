"""PyTorch/CUDA port of DiMSUM for NVIDIA Hopper (H100).

The layout mirrors `dimsum_tpu/` (`ops/`, `models/`, `transport/`,
`utils/`), and modules carry the reference's torch state-dict names, so one
state dict loads here and, through `dimsum_tpu.utils.ckpt`, into the JAX
package.  Hand-written CUDA kernels live in `csrc/` and are built with nvcc
at first use (`ops/cuda_build.py`); each has a plain PyTorch version beside
its wrapper, which CPU tensors take.
"""
