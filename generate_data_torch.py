#!/usr/bin/env python
"""Root-level synthesis entry of the PyTorch port (the surface of
generate_data.py): ``python generate_data_torch.py <shard_id> --teacher DIR``."""

from llm_qat_torch.cli.generate_data import main

if __name__ == "__main__":
    main()
