"""``python -m vqvae_tpu_torch.bench``: the one JSON line (see ``__init__``)."""

import sys

from vqvae_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
