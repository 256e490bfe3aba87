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
stats are bit-identical to the unpacked run's. The churn stage is the bool
engine's too (row-level; ``rewired`` rides the flags word), and the word
tail resets the rejoined rows (``fresh``). Under churn re-wiring the
delivery is the bool engine's on decoded planes, side paths included.
Under a scenario the fault head latches bool planes (the held buffer, the
blackout and partition masks): the round decodes ``seen``, the role words
and ``fault_held`` once, runs the bool head around the engine's bool
delivery (``deliver_bool_factory``) and packs ``incoming``, the effective
transmit plane and the held buffer back. The quorum detector runs as in
the bool engine (its stages are row-level; ``quarantine`` rides the flags
word) and masks a quarantined row's transmit words in the head. Growth
admission is the bool engine's row-level stage too (``exists`` rides the
flags word; the registry planes are carried as they are), and
``degree_gamma`` is computed as there. A stream's age-out drops the
recycled columns from the packed held buffer and hands K4 the expired
mask; its injection decodes the seen words at its boundary and packs the
product, as JAX's packed twin does. The adaptive controller resolves the
round's decision from the decoded seen plane (its slot coverage and needy
rows need bools), hands it to the delivery and runs the control stage
last, decoding the three slot planes it reads. A pipelined round swaps
the delivered words for the buffered ones (``pipe_buf``) and masks a
stream's recycled columns out of the words it stores. A serving window's
batch (``inject``) lands after the stream's injection, decoding the seen
words at that boundary and packing the product, as JAX's
``_ingest_stage_packed`` does.
"""

from __future__ import annotations

import types

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import MatchingPlan
from tpu_gossip_torch.core.packed import FLAG_PLANES, PackedSwarm, bit_column, pack_bits, pack_flags, unpack_bits, unpack_flag
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.kernels import packed_ops as po
from tpu_gossip_torch.kernels.matching import matching_flood, matching_sampled
from tpu_gossip_torch.sim.stages import (Stage, adversary_keys, check_inject, check_later, control_stages,
                                        fault_round, ingest_stages, pipeline_swap, require_quorum, resolve_control,
                                        row_stages, run_stages, stream_stages)

__all__ = [
    "gossip_round_packed",
    "run_protocol_round_packed",
    "advance_round_packed",
    "packed_round_head",
]


def _decode_flags(ps: PackedSwarm) -> dict:
    """The six (N,) row bools out of the shared flags word, once a round."""
    return {n: unpack_flag(ps.flags, n) for n in FLAG_PLANES}


def packed_round_head(ps: PackedSwarm, cfg, flags: dict, liveness=None):
    """(active, role_w, tx_w): the word twin of ``compute_roles`` +
    ``transmit_bitmap`` (+ the quarantine's send mask with ``liveness``).
    ``role_w`` packs ``active[:, None] & ~recovered`` and is both
    transmitter and receptive."""
    active = flags["alive"] & ~flags["declared_dead"]
    role_w = po.role_words(ps.recovered, active, ps.msg_slots)
    tx_w = po.and_words(ps.seen, role_w)
    if cfg.forward_once:
        tx_w = po.andnot_words(tx_w, ps.forwarded)
    if liveness is not None:
        tx_w = po.mask_rows(tx_w, ~flags["quarantine"])
    return active, role_w, tx_w


def _delivery_shim(ps: PackedSwarm, flags: dict, seen_b: torch.Tensor):
    """Duck-typed state for the bool delivery paths (they read exactly
    these fields)."""
    return types.SimpleNamespace(
        seen=seen_b, rewired=flags["rewired"], rewire_targets=ps.rewire_targets,
        row_ptr=ps.row_ptr, col_idx=ps.col_idx,
    )


def _disseminate_local_packed(ps: PackedSwarm, cfg, flags: dict, role_w, tx_w, k_push, k_pull,
                              plan=None, rctl=None, rows=ALL_ROWS):
    """Single-device packed dissemination; returns ``(inc_w, msgs_sent)``.

    Word-native without re-wiring for exactly-k push and push-pull over
    the CSR (the push half decodes the payload for the scatter alone, the
    pull half gathers and ORs words, the bill is popcounts) and for a
    ``MatchingPlan`` (its pipeline moves the state's words, four to an
    int32 word). Every other cell runs the bool engine's delivery on
    decoded planes and packs the product. ``rctl`` is the controller's
    round decision and ``rows`` the rows the state holds, taken as the
    bool engine takes them."""
    from tpu_gossip_torch.kernels.gossip import push_fanout, sample_fanout_targets
    from tpu_gossip_torch.sim import engine as _engine

    m = ps.msg_slots
    gated = cfg.mode == "flood" or (getattr(plan, "fanout", None) is not None
                                    and getattr(plan, "deg_other", None) is not None)
    if isinstance(plan, MatchingPlan) and cfg.rewire_slots == 0 and gated:
        return _matching_words(ps, cfg, role_w, tx_w, k_push, k_pull, plan, rctl)
    word_native = plan is None and cfg.rewire_slots == 0 and cfg.mode in ("push", "push_pull")
    if not word_native:
        role_b = unpack_bits(role_w, m)
        shim = _delivery_shim(ps, flags, unpack_bits(ps.seen, m))
        incoming, msgs_sent = _engine._disseminate_local(
            shim, cfg, unpack_bits(tx_w, m), role_b, role_b, k_push, k_pull, plan, rctl, rows)
        return pack_bits(incoming), msgs_sent

    # the bool engine re-splits both keys; child 0 drives delivery
    k_push = prng.split(k_push)[0]
    k_pull = prng.split(k_pull)[0]
    _engine._require_csr(ps, "XLA sampled delivery")
    tgt, valid = sample_fanout_targets(k_push, ps.row_ptr, ps.col_idx, cfg.fanout if rctl is None else rctl.width)
    push_valid = _engine._width_mask(valid, rctl) & po.rows_any(tx_w)[:, None]
    # the one full-width transient of this path: the scatter ORs bools
    inc_w = pack_bits(push_fanout(unpack_bits(tx_w, m), tgt, push_valid))
    # graftlint: disable=mem-widening-cast -- message counts sum in int64; the stats narrow them to int32
    msgs_sent = (po.popcount_rows(tx_w).to(torch.int64) * push_valid.sum(-1)).sum()
    if cfg.mode == "push_pull":
        # pull answers ship the responder's full seen set
        answer_w = po.and_words(ps.seen, role_w)
        ptgt, pvalid = sample_fanout_targets(k_pull, ps.row_ptr, ps.col_idx, 1)
        pull_ok = _engine._pull_mask(pvalid & po.rows_any(role_w)[:, None], rctl)
        inc_w = po.or_words(inc_w, po.pull_words(answer_w, ptgt, pull_ok))
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
        shipped = po.popcount_rows(answer_w)[ptgt[:, 0].to(torch.int64)] * pull_ok[:, 0]
        msgs_sent = msgs_sent + pull_ok.sum() + shipped.sum()
    return inc_w, msgs_sent.to(torch.int32)


def _matching_words(ps: PackedSwarm, cfg, role_w, tx_w, k_push, k_pull, plan: MatchingPlan, rctl):
    """The matching plan's delivery on the words (no re-wiring): the bool
    engine's key splits and masks (``kernel_path_masks`` without rewired
    rows), its billing, bit for bit."""
    m = ps.msg_slots
    inc_w = torch.zeros_like(ps.seen)
    msgs = torch.zeros((), dtype=torch.int64, device=ps.seen.device)
    if cfg.mode in ("push", "push_pull"):
        if plan.fanout != cfg.fanout:
            raise ValueError(f"plan built for fanout={plan.fanout} but cfg.fanout={cfg.fanout}")
        kp = prng.split(k_push)[0]  # the bool delivery's splits (the re-wiring children go unused)
        answer_w = po.and_words(ps.seen, role_w) if cfg.forward_once else None
        inc_w, n = matching_sampled(
            plan, tx_w, answer_w, m, kp, receptive_rows=po.rows_any(role_w), do_push=True,
            do_pull=cfg.mode == "push_pull", fanout=None if rctl is None else rctl.m_eff,
            pull_gate=None if rctl is None else rctl.pull_on, pull_needy_rows=None if rctl is None else rctl.needy,
            words=True)
        msgs = msgs + n
    if cfg.mode == "flood":
        inc_w = po.or_words(inc_w, matching_flood(plan, tx_w, m, words=True))
        from tpu_gossip_torch.sim.engine import held_degrees

        deg = held_degrees(ps.row_ptr, plan, tx_w.shape[0])
        msgs = msgs + (po.popcount_rows(tx_w).to(torch.int64) * deg).sum()
    return inc_w, msgs.to(torch.int32)


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


def _build_round_stages_packed(cfg, m: int, *, tail: str = "fused", faults=None, churn_faults: bool = False,
                               liveness=None, growth=None, stream=None, host_rng=None,
                               host_rnd: int | None = None, control=None, inject=None,
                               rows=ALL_ROWS) -> tuple[Stage, ...]:
    """The packed stages of one round: the bool engine's row-level
    liveness, churn and growth stages (fault-aware and hardened as there),
    then the word tail, with a stream's age-out before it (the held
    buffer's column drop a packed AND) and its injection after it (the
    seen words decoded and packed again at that boundary), a serving
    batch's landing likewise, then the control stage on decoded planes."""
    return (*row_stages(cfg, faults=faults, churn_faults=churn_faults, liveness=liveness, growth=growth, rows=rows),
            *stream_stages(stream, _tail_stage_packed(cfg, tail, m), host_rng, host_rnd, packed_m=m, rows=rows),
            *ingest_stages(inject, packed_m=m), *control_stages(cfg, control, packed_m=m, rows=rows))


def advance_round_packed(ps: PackedSwarm, cfg, flags: dict, incoming_w, msgs_sent, transmit_w,
                         rnd, key, k_leave, k_join, receptive_w, *, tail: str = "fused", faults=None,
                         churn_faults: bool = False, fault_held_w=None, fstats=None, liveness=None,
                         k_accuse=None, k_forge=None, growth=None, stream=None, host_rng=None,
                         host_rnd: int | None = None, control=None, rctl=None, pipe_buf_w=None, inject=None,
                         rows=ALL_ROWS):
    """Word twin of ``sim.engine.advance_round``: the same stages with the
    slot planes as words under their usual names and the row flags as the
    decoded bools; the flags word is packed again once, at assembly.
    ``fault_held_w`` is the packed delay buffer to carry (the input's when
    None), ``fstats`` the round's fault counters; ``liveness``, the
    adversary arguments, ``growth``, ``stream``, ``control``, ``rctl``,
    ``pipe_buf_w`` (the stored in-flight words, a recycled column masked
    out of them), ``inject`` and ``rows`` as in ``advance_round``."""
    values = {
        "row_ptr": ps.row_ptr, "col_idx": ps.col_idx, "exists": flags["exists"],
        "seen": ps.seen, "forwarded": ps.forwarded,
        "infected_round": ps.infected_round, "recovered": ps.recovered,
        "alive": flags["alive"], "silent": flags["silent"], "last_hb": ps.last_hb,
        "declared_dead": flags["declared_dead"], "rewired": flags["rewired"],
        "rewire_targets": ps.rewire_targets, "degree_credit": ps.degree_credit,
        "join_round": ps.join_round, "admitted_by": ps.admitted_by, "rng": ps.rng,
        "rnd": rnd, "k_leave": k_leave, "k_join": k_join,
        "incoming": incoming_w, "transmit": transmit_w,
        "receptive": receptive_w, "fresh": None, "expired": None, "faults": faults,
        "suspect_round": ps.suspect_round, "suspect_mark": ps.suspect_mark, "quarantine": flags["quarantine"],
        "k_accuse": k_accuse, "k_forge": k_forge, "ltel": None,
        "slot_lease": ps.slot_lease, "held": ps.fault_held if fault_held_w is None else fault_held_w, "stel": None,
        "control_lvl": ps.control_lvl, "rctl": rctl, "fstats": fstats, "seen_prev": ps.seen, "ctel": None,
        "inject": inject, "itel": None,
    }
    values = run_stages(_build_round_stages_packed(cfg, ps.msg_slots, tail=tail, faults=faults,
                                                   churn_faults=churn_faults, liveness=liveness, growth=growth,
                                                   stream=stream, host_rng=host_rng, host_rnd=host_rnd,
                                                   control=control, inject=inject, rows=rows),
                        values)
    if pipe_buf_w is not None and values["expired"] is not None:
        pipe_buf_w = po.mask_cols(pipe_buf_w, pack_bits(~values["expired"]))
    row_flags = dict(flags, exists=values["exists"], alive=values["alive"], silent=values["silent"],
                     declared_dead=values["declared_dead"], rewired=values["rewired"],
                     quarantine=values["quarantine"])
    new_state = PackedSwarm(
        row_ptr=ps.row_ptr, col_idx=ps.col_idx,
        seen=values["seen"], forwarded=values["forwarded"],
        infected_round=values["infected_round"], recovered=values["recovered"],
        flags=pack_flags(row_flags), last_hb=values["last_hb"],
        rewire_targets=values["rewire_targets"],
        fault_held=values["held"],
        join_round=values["join_round"], admitted_by=values["admitted_by"],
        degree_credit=values["degree_credit"], slot_lease=values["slot_lease"],
        control_lvl=values["control_lvl"], pipe_buf=ps.pipe_buf if pipe_buf_w is None else pipe_buf_w,
        suspect_round=values["suspect_round"], suspect_mark=values["suspect_mark"],
        rng=key, round=rnd, msg_slots=ps.msg_slots,
    )
    return new_state, _stats_packed(new_state, row_flags, msgs_sent, fstats, values["ltel"], liveness, growth,
                                    stream, values["stel"], values["ctel"], values["itel"], rows)


def _stats_packed(ps: PackedSwarm, flags: dict, msgs_sent, fstats=None, ltel=None, liveness=None, growth=None,
                  stream=None, stel=None, ctel=None, itel=None, rows=ALL_ROWS):
    """Word twin of ``sim.engine._stats``: the same RoundStats, with the
    slot-0 infection count read off one bit column (popcount and bool sum
    agree bit for bit, the padding being zero); a stream's per-slot
    infected count sums the decoded words, as JAX's twin does."""
    from tpu_gossip_torch.sim.engine import (RoundStats, control_counters, growth_gamma, ingest_counters,
                                             liveness_counters, slot_tracks, stream_counters)

    live = flags["alive"] & ~flags["declared_dead"]
    dev = ps.seen.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    counters = dict.fromkeys(RoundStats._fields, z)
    counters.update(
        coverage=ps.coverage(0),
        msgs_sent=msgs_sent.to(torch.int32),
        n_infected=(bit_column(ps.seen, 0) & live).sum().to(torch.int32),
        n_alive=live.sum().to(torch.int32),
        n_declared_dead=flags["declared_dead"].sum().to(torch.int32),
        n_members=flags["exists"].sum().to(torch.int32),
        degree_gamma=growth_gamma(growth, ps.row_ptr, flags["exists"], flags["rewired"], ps.rewire_targets,
                                  ps.degree_credit, live, rows),
        control_level=torch.full((), -1, dtype=torch.int32, device=dev),
        **slot_tracks(ps.seen if stream is None else unpack_bits(ps.seen, ps.msg_slots), live, ps.slot_lease,
                      ps.round, stream),
    )
    if fstats is not None:
        counters.update(fstats._asdict())
    counters.update(stream_counters(stel))
    counters.update(ingest_counters(itel))
    counters.update(control_counters(ctel))
    counters.update(liveness_counters(ltel, liveness, flags["exists"], flags["alive"], flags["declared_dead"],
                                      flags["quarantine"]))
    return RoundStats(**counters)


def run_protocol_round_packed(ps: PackedSwarm, cfg, deliver_words, deliver_bool_factory=None, *,
                              tail: str = "fused", scenario=None, host_round: int | None = None, liveness=None,
                              growth=None, stream=None, host_rng=None, control=None, pipeline=None, inject=None,
                              rows=ALL_ROWS, **later):
    """Word twin of ``sim.stages.run_protocol_round``: the same 5-way key
    split, the word head, ``deliver_words(tx_w, role_w, flags, k_push,
    k_pull, rctl) -> (inc_w, msgs_sent)``, then the packed stages. Under a
    ``scenario``, ``deliver_bool_factory(flags, seen_b) -> deliver(tx, tr,
    rc, k_push, k_pull, rctl)`` builds the full-width delivery the fault
    head wraps: the round's planes decode once at this boundary and the
    products pack back; the flood replay runs in that head too. The
    adversary stream's fold and ``liveness`` are the bool round's; under
    ``control`` the round's decision is resolved on the decoded seen
    plane; ``pipeline`` swaps the words as ``run_protocol_round`` swaps
    the bool plane; ``inject`` lands a serving window's batch."""
    from tpu_gossip_torch.sim import engine as _engine

    check_later(later)
    check_inject(inject)
    require_quorum(scenario, liveness)
    _engine.validate_rewire_width(ps, cfg)
    m = ps.msg_slots
    rnd = ps.round + 1
    key, k_push, k_pull, k_leave, k_join = prng.split(ps.rng, 5)
    flags = _decode_flags(ps)
    _active, role_w, tx_w = packed_round_head(ps, cfg, flags, liveness)
    # the controller and the fault head read bool slot planes: decode once
    seen_b = None if control is None and scenario is None else unpack_bits(ps.seen, m)
    rctl = None if control is None else resolve_control(control, types.SimpleNamespace(
        control_lvl=ps.control_lvl, alive=flags["alive"], declared_dead=flags["declared_dead"], seen=seen_b,
        slot_lease=ps.slot_lease), cfg, rows)
    k_accuse, k_forge, k_flood = adversary_keys(scenario, ps.rng)
    if scenario is None:
        inc_w, msgs_sent = deliver_words(tx_w, role_w, flags, k_push, k_pull, rctl)
        tx_eff_w, held_w, telem, rf = tx_w, None, None, None
    else:
        from tpu_gossip_torch.faults.inject import scenario_dissemination

        role_b = unpack_bits(role_w, m)
        shim = types.SimpleNamespace(rng=ps.rng, fault_held=unpack_bits(ps.fault_held, m), seen=seen_b,
                                     alive=flags["alive"], declared_dead=flags["declared_dead"],
                                     quarantine=flags["quarantine"])
        deliver = deliver_bool_factory(flags, seen_b)
        incoming, msgs_sent, tx_eff, held, telem, rf = scenario_dissemination(
            scenario, shim, fault_round(ps, host_round), unpack_bits(tx_w, m), role_b, role_b, k_push, k_pull,
            lambda tx, tr, rc, kp, kq: deliver(tx, tr, rc, kp, kq, rctl), k_flood=k_flood, rows=rows)
        inc_w, tx_eff_w, held_w = pack_bits(incoming), pack_bits(tx_eff), pack_bits(held)
    inc_w, pipe_buf_w = pipeline_swap(pipeline, ps.pipe_buf, inc_w)
    return advance_round_packed(ps, cfg, flags, inc_w, msgs_sent, tx_eff_w, rnd, key, k_leave, k_join, role_w,
                                tail=tail, faults=rf, churn_faults=scenario is not None and scenario.has_churn,
                                fault_held_w=held_w, fstats=telem, liveness=liveness, k_accuse=k_accuse,
                                k_forge=k_forge, growth=growth, stream=stream, host_rng=host_rng,
                                host_rnd=None if host_round is None else host_round + 1, control=control, rctl=rctl,
                                pipe_buf_w=pipe_buf_w, inject=inject, rows=rows)


def gossip_round_packed(ps: PackedSwarm, cfg, plan=None, *, tail: str = "fused", rows=ALL_ROWS, **later):
    """Advance a packed swarm one round on its words; returns ``(new packed
    state, RoundStats)``, bit-identical to the bool round (``rows`` as
    there)."""
    from tpu_gossip_torch.sim import engine as _engine

    def deliver_words(tx_w, role_w, flags, kp, kq, rctl):
        return _disseminate_local_packed(ps, cfg, flags, role_w, tx_w, kp, kq, plan, rctl, rows)

    def deliver_bool_factory(flags, seen_b):
        shim = _delivery_shim(ps, flags, seen_b)

        def deliver(tx, tr, rc, kp, kq, rctl):
            return _engine._disseminate_local(shim, cfg, tx, tr, rc, kp, kq, plan, rctl, rows)

        return deliver

    return run_protocol_round_packed(ps, cfg, deliver_words, deliver_bool_factory, tail=tail, rows=rows, **later)
