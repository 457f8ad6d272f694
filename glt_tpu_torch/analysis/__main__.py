"""``python -m glt_tpu_torch.analysis`` entry point."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
