"""`python -m aainterp_torch` — the CLI entry point (``cli.main``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
