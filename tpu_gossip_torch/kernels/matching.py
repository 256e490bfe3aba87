"""Gather-free gossip delivery over a structured-matching topology.

Ports ``matching_flood`` and ``matching_sampled`` (:80) of
``tpu_gossip/kernels/matching.py``: the round's dissemination as

    expand   per-node packed words -> stub slots   (class broadcast)
    partner  slot j <- word of owner(pi(j))        (K1 lane shuffles + transposes)
    reduce   OR slots into receivers               (K2 plane folds + index-add)

Sampling is the Bernoulli-per-edge law: per-slot uint32 thresholds gate
each direction of every surviving edge, one draw per direction per round,
drawn with the same threefry keys as the JAX package. ``msgs`` counts the
delivered slot-bits per fired edge plus one request per fired pull edge of
a receptive puller, in int32. The controller hooks of the JAX signature
(``fanout``, ``pull_gate``, ``pull_needy_rows``) belong to a later slice.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import MatchingPlan
from tpu_gossip_torch.kernels.segment import _slot_groups, pack_words, popcount, unpack_words

__all__ = ["matching_flood", "matching_sampled"]


def _pad_rows(x: torch.Tensor, n_state: int) -> torch.Tensor:
    """Pad per-node results (n, m) to the state's row count (sentinel rows
    receive nothing)."""
    pad = n_state - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x


def matching_flood(plan: MatchingPlan, transmit: torch.Tensor, m: int) -> torch.Tensor:
    """incoming[i] = OR over neighbours j of transmit[j] (flood delivery)."""
    n_state = transmit.shape[0]
    outs = []
    for lo, w in _slot_groups(m):
        words = pack_words(transmit[: plan.n, lo : lo + w])
        across = plan.partner(plan.expand(words))
        across = torch.where(plan.valid, across, 0)
        outs.append(unpack_words(plan.reduce(across, "or"), w))
    inc = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _pad_rows(inc, n_state)


def matching_sampled(
    plan: MatchingPlan,
    transmit: torch.Tensor,
    answer: torch.Tensor | None,
    m: int,
    key: torch.Tensor,
    *,
    receptive_rows: torch.Tensor | None = None,
    do_push: bool = True,
    do_pull: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled (push / push-pull) delivery; returns ``(incoming (n_state, m)
    bool, msgs_sent int32)``. ``answer=None`` answers pulls with
    ``transmit``; ``receptive_rows`` (n_state,) gates the pull half by the
    puller and zeroes non-receptive rows' deliveries."""
    if plan.fanout is None or plan.deg_other is None:
        raise ValueError("plan built without fanout — no sampling gates")
    n_state = transmit.shape[0]
    shape = (plan.rows, 128)
    k_push, k_pull = prng.split(key)
    msgs = torch.zeros((), dtype=torch.int64, device=transmit.device)
    rec_rows_n = rec_slots = None
    if receptive_rows is not None:
        rec_rows_n = receptive_rows[: plan.n]
        rec_slots = plan.expand(rec_rows_n.to(torch.int32)) > 0
    active_p = active_q = pull_bill = None
    if do_push:
        active_p = prng.bits(k_push, shape) < plan.push_threshold()
    if do_pull:
        active_q = prng.bits(k_pull, shape) < plan.pull_threshold()
        pull_bill = active_q.to(torch.int32)
    outs = []
    for lo, w in _slot_groups(m):
        tx_words = pack_words(transmit[: plan.n, lo : lo + w])
        slot_tx = plan.partner(plan.expand(tx_words))
        combined = torch.zeros(shape, dtype=torch.int32, device=transmit.device)
        if do_push:
            wp = torch.where(active_p, slot_tx, 0)
            combined = combined | wp
            msgs = msgs + popcount(wp).sum()
        if do_pull:
            slot_ans = (
                slot_tx
                if answer is None
                else plan.partner(plan.expand(pack_words(answer[: plan.n, lo : lo + w])))
            )
            wq = torch.where(active_q, slot_ans, 0)
            combined = combined | wq
            pull_bill = pull_bill + popcount(wq)
        outs.append(unpack_words(plan.reduce(combined, "or"), w))
    incoming = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if rec_rows_n is not None:
        incoming = incoming & rec_rows_n[:, None]
    if do_pull:
        if rec_slots is not None:
            pull_bill = torch.where(rec_slots, pull_bill, 0)
        msgs = msgs + pull_bill.sum()
    return _pad_rows(incoming, n_state), msgs.to(torch.int32)
