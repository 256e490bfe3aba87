"""Several processes: the (hosts, devices) mesh, the hierarchical transport
and the launcher.

Ports ``tpu_gossip/cluster/``:

- :mod:`tpu_gossip_torch.cluster.topology`: the axis model
  (``make_cluster_mesh``, ``mesh_hosts``) and the process group's
  exchange, reductions and row gather;
- :mod:`tpu_gossip_torch.cluster.hier`: the two-level ICI/DCN stage
  decompositions ``--transport hier`` runs;
- :mod:`tpu_gossip_torch.cluster.launch`: ``torch.distributed``
  initialisation and the localhost launcher of ``run_sim`` ranks.

The package imports torch only when one of its torch-side names is first
read, so the launcher (``python -m tpu_gossip_torch.cluster.launch``)
starts without it.
"""

import importlib

__all__ = ["HOST_AXIS", "DEVICE_AXIS", "LOCAL_SHARDS_ENV", "Mesh", "make_cluster_mesh", "mesh_hosts"]

# the number of shards each process holds when the caller names no mesh
# size (the launcher's --devices-per-host)
LOCAL_SHARDS_ENV = "TPU_GOSSIP_TORCH_LOCAL_SHARDS"


def __getattr__(name: str):
    if name in __all__:
        return getattr(importlib.import_module("tpu_gossip_torch.cluster.topology"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
