"""Gather-free gossip delivery over a structured-matching topology.

Ports ``matching_flood`` and ``matching_sampled`` (:80) of
``tpu_gossip/kernels/matching.py``: the round's dissemination as

    expand   per-node packed words -> stub slots   (class broadcast)
    partner  slot j <- word of owner(pi(j))        (K1 lane shuffles, transposes fused in)
    reduce   OR slots into receivers               (K2, one launch over the class table)

Sampling is the Bernoulli-per-edge law: per-slot uint32 thresholds gate
each direction of every surviving edge, one draw per direction per round,
drawn with the same threefry keys as the JAX package (a process holding
some of a mesh's shards draws its rows' block of the global draw). ``msgs`` counts the
delivered slot-bits per fired edge plus one request per fired pull edge of
a receptive puller, in int32. The adaptive controller's hooks
(``fanout``, ``pull_gate``, ``pull_needy_rows``) move only the gates.
With ``words`` the slot planes are a packed state's (n, W) uint8 bit
words, moved four to an int32 word, and so is the product.

The partner pass is the plan's own (``MatchingPlan.partner``): the fused
local pipeline, or on a mesh the sharded passes its ``route`` names, so
the sharded engine runs this delivery unchanged.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import MatchingPlan
from tpu_gossip_torch.core.packed import packed_width, words8_to_words32, words32_to_words8
from tpu_gossip_torch.kernels.pallas_segment import (_slot_groups, check_control_hooks, pack_words, popcount,
                                                     unpack_words)

__all__ = ["matching_flood", "matching_sampled"]


def _pad_rows(x: torch.Tensor, n_state: int) -> torch.Tensor:
    """Pad per-node results (n, m) to the state's row count (sentinel rows
    receive nothing)."""
    pad = n_state - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x


def _group_words(x: torch.Tensor, m: int, words: bool) -> list[torch.Tensor]:
    """(n,) int32 words of each 32-slot group of ``x``: bool (n, m) slots,
    or the packed (n, W) uint8 words with ``words``."""
    if words:
        w32 = words8_to_words32(x)
        return [w32[:, g] for g in range(w32.shape[1])]
    return [pack_words(x[:, lo : lo + w]) for lo, w in _slot_groups(m)]


def _ungroup(outs: list[torch.Tensor], m: int, words: bool) -> torch.Tensor:
    if words:
        return words32_to_words8(torch.stack(outs, dim=1), packed_width(m))
    parts = [unpack_words(o, w) for o, (_, w) in zip(outs, _slot_groups(m))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def matching_flood(plan: MatchingPlan, transmit: torch.Tensor, m: int, *, words: bool = False) -> torch.Tensor:
    """incoming[i] = OR over neighbours j of transmit[j] (flood delivery)."""
    outs = []
    for txg in _group_words(transmit[: plan.n], m, words):
        across = torch.where(plan.valid, plan.partner(plan.expand(txg)), 0)
        outs.append(plan.reduce(across, "or"))
    return _pad_rows(_ungroup(outs, m, words), transmit.shape[0])


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
    fanout: torch.Tensor | None = None,
    pull_gate: torch.Tensor | None = None,
    pull_needy_rows: torch.Tensor | None = None,
    words: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled (push / push-pull) delivery; returns ``(incoming (n_state, m)
    bool, msgs_sent int32)``, the incoming (n_state, W) uint8 words with
    ``words`` (``transmit`` and ``answer`` words too; ``receptive_rows``
    stays a row mask). ``answer=None`` answers pulls with
    ``transmit``; ``receptive_rows`` (n_state,) gates the pull half by the
    puller and zeroes non-receptive rows' deliveries.

    The controller's round decision: ``fanout`` (int32 0-d tensor) enters
    the push law ``B(fanout/deg)``, recomputed from the same degree tables
    (equal to the plan's static fanout, the gates are the static ones);
    ``pull_gate`` (bool 0-d) masks the pull activation, billing included;
    ``pull_needy_rows`` ((n_state,) bool) masks it by the puller, through
    the class expand the receptive gate rides."""
    if plan.fanout is None or plan.deg_other is None:
        raise ValueError("plan built without fanout — no sampling gates")
    n_state = transmit.shape[0]
    check_control_hooks(n_state, fanout, pull_gate, pull_needy_rows)
    shape = (plan.rows, 128)
    k_push, k_pull = prng.split(key)
    msgs = torch.zeros((), dtype=torch.int64, device=transmit.device)
    rec_rows_n = rec_slots = None
    if receptive_rows is not None:
        rec_rows_n = receptive_rows[: plan.n]
        rec_slots = plan.expand(rec_rows_n.to(torch.int32)) > 0
    active_p = active_q = pull_bill = None
    if do_push:
        active_p = prng.bits(k_push, shape, plan.draw_offset) < plan.push_threshold(fanout)
    if do_pull:
        active_q = prng.bits(k_pull, shape, plan.draw_offset) < plan.pull_threshold()
        if pull_gate is not None:
            active_q = active_q & pull_gate
        if pull_needy_rows is not None:
            active_q = active_q & (plan.expand(pull_needy_rows[: plan.n].to(torch.int32)) > 0)
        pull_bill = active_q.to(torch.int32)
    tx_groups = _group_words(transmit[: plan.n], m, words)
    ans_groups = (_group_words(answer[: plan.n], m, words) if do_pull and answer is not None
                  else [None] * len(tx_groups))
    outs = []
    for txg, ansg in zip(tx_groups, ans_groups):
        slot_tx = plan.partner(plan.expand(txg))
        combined = torch.zeros(shape, dtype=torch.int32, device=transmit.device)
        if do_push:
            wp = torch.where(active_p, slot_tx, 0)
            combined = combined | wp
            msgs = msgs + popcount(wp).sum()
        if do_pull:
            slot_ans = slot_tx if ansg is None else plan.partner(plan.expand(ansg))
            wq = torch.where(active_q, slot_ans, 0)
            combined = combined | wq
            pull_bill = pull_bill + popcount(wq)
        outs.append(plan.reduce(combined, "or"))
    incoming = _ungroup(outs, m, words)
    if rec_rows_n is not None:
        rec = rec_rows_n[:, None]
        incoming = torch.where(rec, incoming, 0) if words else incoming & rec
    if do_pull:
        if rec_slots is not None:
            pull_bill = torch.where(rec_slots, pull_bill, 0)
        msgs = msgs + pull_bill.sum()
    return _pad_rows(incoming, n_state), msgs.to(torch.int32)
