"""``python -m dewi_tpu_torch <command>``: the port's command line."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
