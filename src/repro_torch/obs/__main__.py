"""``python -m repro_torch.obs`` — summarize/validate telemetry files."""
import sys

from .summarize import main

if __name__ == "__main__":
    sys.exit(main())
