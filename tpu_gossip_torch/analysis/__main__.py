"""``python -m tpu_gossip_torch.analysis``: the port's graftlint CLI."""

import sys

from tpu_gossip_torch.analysis.cli import main

sys.exit(main())
