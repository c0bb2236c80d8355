#!/usr/bin/env python
"""Root-level QAT training entry of the PyTorch port (the surface of
train.py): ``python train_torch.py --input_model_filename DIR ...`` with
train.py's flags, plus ``--device cpu`` to run without a card."""

from llm_qat_torch.cli.train import main

if __name__ == "__main__":
    main()
