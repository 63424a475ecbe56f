"""``python -m repro_torch`` — see `repro_torch.pipeline.cli`."""

import sys

from repro_torch.pipeline.cli import main

if __name__ == "__main__":
    sys.exit(main())
