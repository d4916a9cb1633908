import sys

from myraytracer_tpu_torch.cli import main

sys.exit(main())
