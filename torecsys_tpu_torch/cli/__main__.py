"""``python -m torecsys_tpu_torch.cli``: the port's command line."""

import sys

from torecsys_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
