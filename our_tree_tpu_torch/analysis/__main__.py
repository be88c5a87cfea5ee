"""``python -m our_tree_tpu_torch.analysis``: the otlint CLI over the port
(``driver.main``)."""

import sys

from .driver import main

if __name__ == "__main__":
    sys.exit(main())
