"""The packed-native protocol round: the round program on the bit words.

Ports ``tpu_gossip/sim/packed_engine.py`` for the planes the port runs. A
``PackedSwarm`` round computes on the ``(N, W)`` uint8 words
(``kernels/packed_ops.py``): role masks, the forward-once latch, the
push/pull delivery merge, the round tail (``round_tail_words``, K4 on the
card) and every infection count. Full width exists only where an op needs
it:

- the exactly-k push scatter (``push_fanout``): the transmit payload
  decodes just before the scatter and the product packs right after; the
  pull half is a gather and an OR on words end to end;
- the kernel-plan delivery (matching, staircase) and flood, which run the
  bool engine's ``_disseminate_local`` on decoded planes and pack the
  product.

The liveness stage is the bool engine's, unchanged: it reads only (N,) row
masks, decoded once a round from the shared flags word. The key sequence is
the bool round's, split for split, so a packed run's state and integer
stats are bit-identical to the unpacked run's. Scenarios, growth, streams,
control, pipelining, the quorum detector, live ingestion and churn are
later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import types

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import FLAG_PLANES, PackedSwarm, bit_column, pack_bits, pack_flags, unpack_bits, unpack_flag
from tpu_gossip_torch.kernels import packed_ops as po
from tpu_gossip_torch.sim.stages import Stage, _liveness_stage, check_later, not_ported, run_stages

__all__ = [
    "gossip_round_packed",
    "run_protocol_round_packed",
    "advance_round_packed",
    "packed_round_head",
]


def _decode_flags(ps: PackedSwarm) -> dict:
    """The six (N,) row bools out of the shared flags word, once a round."""
    return {n: unpack_flag(ps.flags, n) for n in FLAG_PLANES}


def packed_round_head(ps: PackedSwarm, cfg, flags: dict):
    """(active, role_w, tx_w): the word twin of ``compute_roles`` +
    ``transmit_bitmap``. ``role_w`` packs ``active[:, None] & ~recovered``
    and is both transmitter and receptive."""
    active = flags["alive"] & ~flags["declared_dead"]
    role_w = po.role_words(ps.recovered, active, ps.msg_slots)
    tx_w = po.and_words(ps.seen, role_w)
    if cfg.forward_once:
        tx_w = po.andnot_words(tx_w, ps.forwarded)
    return active, role_w, tx_w


def _delivery_shim(ps: PackedSwarm, flags: dict, seen_b: torch.Tensor):
    """Duck-typed state for the bool delivery paths (they read exactly
    these fields)."""
    return types.SimpleNamespace(
        seen=seen_b, rewired=flags["rewired"], rewire_targets=ps.rewire_targets,
        row_ptr=ps.row_ptr, col_idx=ps.col_idx,
    )


def _disseminate_local_packed(ps: PackedSwarm, cfg, flags: dict, role_w, tx_w, k_push, k_pull,
                              plan=None):
    """Single-device packed dissemination; returns ``(inc_w, msgs_sent)``.

    Word-native for exactly-k push and push-pull over the CSR (no plan, no
    re-wiring): the push half decodes the payload for the scatter alone,
    the pull half gathers and ORs words, and the bill is popcounts. Every
    other cell runs the bool engine's delivery on decoded planes and packs
    the product."""
    from tpu_gossip_torch.kernels.gossip import push_fanout, sample_fanout_targets
    from tpu_gossip_torch.sim import engine as _engine

    m = ps.msg_slots
    word_native = plan is None and cfg.rewire_slots == 0 and cfg.mode in ("push", "push_pull")
    if not word_native:
        role_b = unpack_bits(role_w, m)
        shim = _delivery_shim(ps, flags, unpack_bits(ps.seen, m))
        incoming, msgs_sent = _engine._disseminate_local(
            shim, cfg, unpack_bits(tx_w, m), role_b, role_b, k_push, k_pull, plan)
        return pack_bits(incoming), msgs_sent

    # the bool engine re-splits both keys; child 0 drives delivery
    k_push = prng.split(k_push)[0]
    k_pull = prng.split(k_pull)[0]
    _engine._require_csr(ps, "XLA sampled delivery")
    tgt, valid = sample_fanout_targets(k_push, ps.row_ptr, ps.col_idx, cfg.fanout)
    push_valid = valid & po.rows_any(tx_w)[:, None]
    # the one full-width transient of this path: the scatter ORs bools
    inc_w = pack_bits(push_fanout(unpack_bits(tx_w, m), tgt, push_valid))
    msgs_sent = (po.popcount_rows(tx_w).to(torch.int64) * push_valid.sum(-1)).sum()
    if cfg.mode == "push_pull":
        # pull answers ship the responder's full seen set
        answer_w = po.and_words(ps.seen, role_w)
        ptgt, pvalid = sample_fanout_targets(k_pull, ps.row_ptr, ps.col_idx, 1)
        pull_ok = pvalid & po.rows_any(role_w)[:, None]
        inc_w = po.or_words(inc_w, po.pull_words(answer_w, ptgt, pull_ok))
        shipped = po.popcount_rows(answer_w)[ptgt[:, 0].to(torch.int64)] * pull_ok[:, 0]
        msgs_sent = msgs_sent + pull_ok.sum() + shipped.sum()
    return inc_w, msgs_sent.to(torch.int32)


def _tail_stage_packed(cfg, tail: str, m: int) -> Stage:
    """Word twin of ``sim.stages._tail_stage``: one traversal of the word
    planes (``round_tail_words``, K4 on the card). ``pallas`` and
    ``packed_pallas`` take the saturated SIR age, the other impls the wide
    one, as the JAX package maps them; ``reference`` is the CPU oracle."""
    from tpu_gossip_torch.kernels.round_tail import TAIL_IMPLS, round_tail_words

    if tail not in TAIL_IMPLS:
        raise ValueError(f"unknown tail impl {tail!r}; choose from {TAIL_IMPLS}")
    reads = ("seen", "forwarded", "infected_round", "recovered", "incoming",
             "receptive", "transmit", "fresh", "rnd", "expired")
    writes = ("seen", "forwarded", "infected_round", "recovered")

    def fn(ctx):
        if tail == "reference" and ctx["seen"].device.type != "cpu":
            raise ValueError("tail impl 'reference' is the CPU oracle; on CUDA use 'fused' (K4)")
        seen, forwarded, infected_round, recovered = round_tail_words(
            ctx["seen"], ctx["forwarded"], ctx["infected_round"], ctx["recovered"],
            ctx["incoming"], ctx["receptive"], ctx["transmit"], ctx["fresh"], ctx["rnd"],
            m=m, forward_once=cfg.forward_once, sir_recover_rounds=cfg.sir_recover_rounds,
            expired=ctx["expired"], pallas=tail in ("pallas", "packed_pallas"),
        )
        return {"seen": seen, "forwarded": forwarded,
                "infected_round": infected_round, "recovered": recovered}

    return Stage("tail", reads, writes, fn)


def _build_round_stages_packed(cfg, m: int, *, tail: str = "fused") -> tuple[Stage, ...]:
    """The packed stages of one config: the bool engine's liveness stage
    (row-level), then the word tail."""
    if cfg.churn_leave_prob > 0.0 or cfg.churn_join_prob > 0.0:
        raise not_ported("churn (churn_leave_prob/churn_join_prob)", "churn and re-wiring")
    return (_liveness_stage(cfg), _tail_stage_packed(cfg, tail, m))


def advance_round_packed(ps: PackedSwarm, cfg, flags: dict, incoming_w, msgs_sent, transmit_w,
                         rnd, key, receptive_w, *, tail: str = "fused"):
    """Word twin of ``sim.engine.advance_round``: the same stages with the
    slot planes as words under their usual names and the row flags as the
    decoded bools; the flags word is packed again once, at assembly."""
    values = {
        "seen": ps.seen, "forwarded": ps.forwarded,
        "infected_round": ps.infected_round, "recovered": ps.recovered,
        "alive": flags["alive"], "silent": flags["silent"], "last_hb": ps.last_hb,
        "declared_dead": flags["declared_dead"], "rnd": rnd,
        "incoming": incoming_w, "transmit": transmit_w,
        "receptive": receptive_w, "fresh": None, "expired": None,
    }
    values = run_stages(_build_round_stages_packed(cfg, ps.msg_slots, tail=tail), values)
    row_flags = dict(flags, alive=values["alive"], silent=values["silent"],
                     declared_dead=values["declared_dead"])
    new_state = PackedSwarm(
        row_ptr=ps.row_ptr, col_idx=ps.col_idx,
        seen=values["seen"], forwarded=values["forwarded"],
        infected_round=values["infected_round"], recovered=values["recovered"],
        flags=pack_flags(row_flags), last_hb=values["last_hb"],
        rewire_targets=ps.rewire_targets, fault_held=ps.fault_held,
        join_round=ps.join_round, admitted_by=ps.admitted_by,
        degree_credit=ps.degree_credit, slot_lease=ps.slot_lease,
        control_lvl=ps.control_lvl, pipe_buf=ps.pipe_buf,
        suspect_round=ps.suspect_round, suspect_mark=ps.suspect_mark,
        rng=key, round=rnd, msg_slots=ps.msg_slots,
    )
    return new_state, _stats_packed(new_state, row_flags, msgs_sent)


def _stats_packed(ps: PackedSwarm, flags: dict, msgs_sent):
    """Word twin of ``sim.engine._stats``: the same RoundStats, with the
    slot-0 infection count read off one bit column (popcount and bool sum
    agree bit for bit, the padding being zero)."""
    from tpu_gossip_torch.sim.engine import RoundStats

    live = flags["alive"] & ~flags["declared_dead"]
    dev = ps.seen.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    zm = torch.zeros((ps.msg_slots,), dtype=torch.int32, device=dev)
    counters = dict.fromkeys(RoundStats._fields, z)
    counters.update(
        coverage=ps.coverage(0),
        msgs_sent=msgs_sent.to(torch.int32),
        n_infected=(bit_column(ps.seen, 0) & live).sum().to(torch.int32),
        n_alive=live.sum().to(torch.int32),
        n_declared_dead=flags["declared_dead"].sum().to(torch.int32),
        n_members=flags["exists"].sum().to(torch.int32),
        degree_gamma=torch.zeros((), dtype=torch.float32, device=dev),
        slot_infected=zm,
        slot_age=zm,
        control_level=torch.full((), -1, dtype=torch.int32, device=dev),
    )
    return RoundStats(**counters)


def run_protocol_round_packed(ps: PackedSwarm, cfg, deliver_words, *, tail: str = "fused", **later):
    """Word twin of ``sim.stages.run_protocol_round``: the same 5-way key
    split, the word head, ``deliver_words(tx_w, role_w, flags, k_push,
    k_pull) -> (inc_w, msgs_sent)``, then the packed stages."""
    from tpu_gossip_torch.sim import engine as _engine

    check_later(later)
    _engine.validate_rewire_width(ps, cfg)
    rnd = ps.round + 1
    key, k_push, k_pull, _k_leave, _k_join = prng.split(ps.rng, 5)
    flags = _decode_flags(ps)
    _active, role_w, tx_w = packed_round_head(ps, cfg, flags)
    inc_w, msgs_sent = deliver_words(tx_w, role_w, flags, k_push, k_pull)
    return advance_round_packed(ps, cfg, flags, inc_w, msgs_sent, tx_w, rnd, key, role_w, tail=tail)


def gossip_round_packed(ps: PackedSwarm, cfg, plan=None, *, tail: str = "fused", **later):
    """Advance a packed swarm one round on its words; returns ``(new packed
    state, RoundStats)``, bit-identical to the bool round."""

    def deliver_words(tx_w, role_w, flags, kp, kq):
        return _disseminate_local_packed(ps, cfg, flags, role_w, tx_w, kp, kq, plan)

    return run_protocol_round_packed(ps, cfg, deliver_words, tail=tail, **later)
