import sys

from repro_torch.tuner.cli import main

sys.exit(main())
