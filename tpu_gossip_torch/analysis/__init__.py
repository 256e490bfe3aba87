"""graftlint for the port: the analysis tier of ``tpu_gossip_torch``.

The counterpart of the JAX package's ``tpu_gossip/analysis``, over the
port's own code and entry points:

- AST rules (``registry.py`` and ``rules_*.py``) over ``walker.py``'s
  module and project index: ``key-linearity`` and ``global-torch-rng``
  (every draw from an explicit threefry key, each key consumed once),
  ``round-host-sync`` (no host read in round-reachable code),
  ``raw-collective`` (``torch.distributed`` from the cluster layer only),
  ``state-in-place`` (rounds write no plane of their input).
- The entry matrix (``entrypoints.py``): the JAX package's entry points
  under the same names, each built from a seed on a given device.
- The contract audit (``contracts.py``): each entry run once; the output
  state keeps the input's planes, ``RoundStats`` and the ICI counters
  their declared shapes and dtypes.
- The memory tier (``mem/``): declared plane widths, widening casts and
  peak live bytes from the op recorder (``optrace.py``, CPU only), the
  committed budget (``memory_budget.toml``, 5% tolerance) and the dense
  wire census against ``dense_wire_words``.
- Pragmas (``# graftlint: disable=<rule> -- reason``) and an empty
  ``lint_baseline.toml``.

Run: ``python -m tpu_gossip_torch.analysis --device cpu [--mem]`` or
``tpu-gossip-torch-lint``. Importing this package registers the rules and
imports nothing of the code it analyses.
"""

from tpu_gossip_torch.analysis import rules_collective, rules_prng, rules_purity, rules_state  # noqa: F401
from tpu_gossip_torch.analysis.cli import lint_paths, main
from tpu_gossip_torch.analysis.registry import RULES, Finding, run_rules

__all__ = ["Finding", "RULES", "run_rules", "lint_paths", "main"]
