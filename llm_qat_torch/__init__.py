"""PyTorch / CUDA port of llm_qat_tpu for NVIDIA Hopper.

The first slice is the true-int serving path (``inference``): quantized
params, the serving forward with its quantized KV cache, and the
continuous-batching engine, over four hand-written CUDA kernels
(``csrc/``). Importing the package needs neither CUDA nor ``nvcc``: kernels
build at first use on the GPU host (``ops/_build.py``).
"""
