"""``python -m streamz_tpu_torch`` — the port's CLI entry point."""

import sys

from streamz_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
