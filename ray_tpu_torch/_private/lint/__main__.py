import sys

from ray_tpu_torch._private.lint.cli import main

sys.exit(main())
