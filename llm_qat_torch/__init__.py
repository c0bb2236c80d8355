"""PyTorch / CUDA port of llm_qat_tpu for NVIDIA Hopper.

Ported so far are true-int serving, KD-QAT training and the paper's
pipeline around it. Serving
(``inference``): quantized params (``quantized``), the serving forward with its contiguous quantized KV cache
(``model``, decode steps in the whole-model kernel of ``megakernel`` by
default), the continuous-batching engine (``engine.InferenceEngine``), and
paged serving: the page pool with block tables (``paged.paged_forward``,
replacing ``llm_qat_tpu/inference/paged.py``) and the engine with lazy
allocation and preemption (``paged_engine.PagedInferenceEngine``, replacing
``llm_qat_tpu/inference/paged_engine.py``).

Training (``training.trainer``): the single-device KD-QAT train step (frozen
teacher, fake-quant student forward and backward under rematerialization,
KL loss, clip + AdamW) over ``models.llama``'s training forward, the
fake-quant primitives (``ops.quantize``, ``ops.linear``, ``ops.qat_matmul``)
and the producer-fused blocks (``ops.fused_layer``).

Pipeline: HF checkpoint I/O with a hand-written safetensors reader and
writer (``models.convert``), the jsonl -> block data pipeline
(``data.dataset``, with the C++ reader of ``native``), data-free synthesis
from the teacher on the cached decode path (``data.synthesis``,
``models.llama.forward_with_cache``), step checkpoints (``utils.checkpoint``)
and the entry points ``cli.train`` and ``cli.generate_data``.

Thirteen hand-written CUDA kernels (``csrc/``, wrappers in ``ops/`` and
``inference/megakernel.py``), by the function of
``llm_qat_tpu/ops/pallas/`` each replaces: ``quant_matmul.int8_matmul``,
``int4_matmul``, ``int8_matmul_stacked``, ``int4_matmul_stacked``;
``decode_attention.quantized_decode_attention``,
``quantized_decode_attention_stacked``, ``quantized_paged_attention``;
``flash_attention`` (forward, and the backward pair dQ and dK/dV);
``fused_quant.rmsnorm_quant`` and ``silu_mul_quant``; and
``llm_qat_tpu/inference/megakernel.py``'s ``decode_step``. Importing the package needs neither CUDA nor ``nvcc``:
kernels build at first use on the GPU host (``ops/_build.py``).
"""
