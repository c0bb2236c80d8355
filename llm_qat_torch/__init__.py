"""PyTorch / CUDA port of llm_qat_tpu for NVIDIA Hopper.

Ported so far is true-int serving (``inference``): quantized params
(``quantized``), the serving forward with its contiguous quantized KV cache
(``model``, decode steps in the whole-model kernel of ``megakernel`` by
default), the continuous-batching engine (``engine.InferenceEngine``), and
paged serving: the page pool with block tables (``paged.paged_forward``,
replacing ``llm_qat_tpu/inference/paged.py``) and the engine with lazy
allocation and preemption (``paged_engine.PagedInferenceEngine``, replacing
``llm_qat_tpu/inference/paged_engine.py``).

Nine hand-written CUDA kernels (``csrc/``, wrappers in ``ops/`` and
``inference/megakernel.py``), by the function of
``llm_qat_tpu/ops/pallas/`` each replaces: ``quant_matmul.int8_matmul``,
``int4_matmul``, ``int8_matmul_stacked``, ``int4_matmul_stacked``;
``decode_attention.quantized_decode_attention``,
``quantized_decode_attention_stacked``, ``quantized_paged_attention``;
``flash_attention`` (forward); and ``llm_qat_tpu/inference/megakernel.py``'s
``decode_step``. Importing the package needs neither CUDA nor ``nvcc``:
kernels build at first use on the GPU host (``ops/_build.py``).
"""
