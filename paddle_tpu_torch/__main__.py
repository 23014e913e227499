"""`python -m paddle_tpu_torch <verb>`: the port's command-line driver
(see `paddle_tpu_torch.cli`)."""

import sys

from paddle_tpu_torch.cli import main

sys.exit(main())
