"""Probes and profiles of the port on the card, one module per script of
the JAX package's ``experiments/``: ``python -m
tpu_gossip_torch.experiments.<name>``."""
