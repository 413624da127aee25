"""``python -m xna_basecaller_tpu_torch`` entry point."""

import sys

from xna_basecaller_tpu_torch.cli import main

sys.exit(main())
