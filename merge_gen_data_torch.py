#!/usr/bin/env python
"""Root-level chunk merger of the PyTorch port (the surface of
merge_gen_data.py): concatenates ``gen_data/gen.chunk.*.jsonl``."""

import sys

from llm_qat_torch.cli.generate_data import main

if __name__ == "__main__":
    main(["--merge"] + sys.argv[1:])
