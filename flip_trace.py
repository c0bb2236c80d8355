"""Where the card's serving path first parts from the CPU path, op by op.

    python3 flip_trace.py [--layers 2] [--seed 21] [--prompt_len 16]

Runs one greedy prefill + 4 decode steps of a TinyLlama-1.1B cut (W8A8KV8,
the scan path, bf16, random weights from ``--seed``; by default the
tensor-parallel phase's 2-layer cut and 16-token prompt of ``chip_smoke.py``)
on the card and, teacher-forced with the card's tokens, on the CPU (the
plain versions), recording every op of the serving layers in call order:
``llama.rms_norm``, ``llama.rope_cos_sin``, ``llama.apply_rope``, the flash
prefill (K4), each projection's activation quantizer (its int8 codes) and
its ``quant_linear`` output. It prints, for each run, the first op whose
output parts between the two devices and whether that op's inputs were
equal there (then the op itself rounds otherwise), the first quantizer whose
codes part (``chip_smoke.first_code_parting``'s rule), and the last line as
one JSON object. Needs a card; imports no JAX.
"""

import argparse
import json
import sys

import numpy as np
import torch


def _cpu(t):
    return t.detach().to("cpu") if isinstance(t, torch.Tensor) else t


class Recorder:
    """Wraps the serving layer's module-level ops; ``log`` holds (name,
    inputs, output) on the host in call order."""

    def __init__(self):
        from llm_qat_torch.inference import model as M
        from llm_qat_torch.inference import quantized as Q
        from llm_qat_torch.models import llama
        from llm_qat_torch.ops import quant_matmul as QM

        self.log = []
        self.targets = [(llama, "rms_norm"), (llama, "rope_cos_sin"), (llama, "apply_rope"),
                        (M, "flash_attention"), (Q, "quant_linear"), (QM, "quantize_rows")]
        self.real = {}

    def _wrap(self, mod, name):
        real = getattr(mod, name)

        def rec(*a, **k):
            out = real(*a, **k)
            outs = out if isinstance(out, tuple) else (out,)
            self.log.append((name, [_cpu(x) for x in a if isinstance(x, torch.Tensor)],
                             [_cpu(x) for x in outs if isinstance(x, torch.Tensor)]))
            return out
        return real, rec

    def __enter__(self):
        for mod, name in self.targets:
            real, rec = self._wrap(mod, name)
            self.real[(mod, name)] = real
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self.real.items():
            setattr(mod, name, real)


def _same(a, b):
    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(x, y)
                                    for x, y in zip(a, b))


def first_parting(ref, got):
    """The first op whose outputs part, with what is known of it."""
    if len(ref) != len(got):
        raise AssertionError(f"{len(ref)} ops against {len(got)}")
    for i, ((name, ai, ao), (name2, bi, bo)) in enumerate(zip(ref, got)):
        if name != name2:
            raise AssertionError(f"op {i}: {name} against {name2}")
        if not _same(ao, bo):
            d = [(x.double() - y.double()).abs() for x, y in zip(ao, bo)]
            return dict(op=i, name=name, inputs_equal=_same(ai, bi),
                        elements=int(sum((x > 0).sum() for x in d)),
                        of=int(sum(x.numel() for x in ao)),
                        max_abs=float(max(x.max() for x in d)),
                        before=[n for n, _, _ in ref[max(0, i - 3):i]])
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--prompt_len", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flip_trace: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from llm_qat_torch.inference import quantized as Q
    from llm_qat_torch.models import params as P
    from llm_qat_torch.models.config import TINYLLAMA_1B

    cut = TINYLLAMA_1B.replace(w_bits=8, a_bits=8, kv_bits=8, num_hidden_layers=args.layers,
                               use_megakernel=False)
    prompt = list(map(int, np.random.default_rng(args.seed).integers(
        1, cut.vocab_size, args.prompt_len)))
    params = P.init_params(cut, seed=args.seed, dtype=torch.bfloat16)
    gpu_q = Q.quantize_params(params, cut)
    cpu_q = Q.quantize_params(params, cut, device="cpu")
    toks = []
    with Recorder() as rg:
        gl = CS._greedy_logits(cut, gpu_q, prompt, "cuda", toks)
    with Recorder() as rc:
        cl = CS._greedy_logits(cut, cpu_q, prompt, "cpu", toks)
    ops = first_parting(rc.log, rg.log)
    codes = [o[0] for n, _, o in rc.log if n == "quantize_rows"]
    gcodes = [o[0] for n, _, o in rg.log if n == "quantize_rows"]
    parting = CS.first_code_parting(codes, gcodes, args.layers)
    same, drift = CS._compare_steps(gl, cl)
    print(f"{torch.cuda.get_device_name(0)}; TinyLlama-1.1B W8A8KV8 scan path, "
          f"{args.layers} layers, seed {args.seed}, {len(prompt)}-token prompt + 4 steps: "
          f"{len(rg.log)} ops recorded a device")
    print(f"first op whose output parts: {ops}")
    print(f"first quantizer whose codes part: {CS.parting_text(parting)}")
    print(f"greedy tokens equal per step {same}, relative L2 drift {drift}")
    print(json.dumps(dict(first_op=ops, codes=parting, tokens_equal=same, drift=drift,
                          card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
