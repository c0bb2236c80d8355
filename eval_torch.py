#!/usr/bin/env python
"""Root-level evaluation entry of the PyTorch port (the surface of eval.py):
``python eval_torch.py --model DIR --tasks boolq,piqa --task_dir tasks/ ...``
with eval.py's flags, plus ``--device cpu`` to run without a card."""

from llm_qat_torch.cli.eval import main

if __name__ == "__main__":
    main()
