"""In-round admission: the growth engine's on-device half.

Ports ``tpu_gossip/growth/engine.py``. One call to :func:`apply_growth`
admits one round's join batch as the row-level growth stage of the round
(``sim/stages.py``), shared by every engine:

- the batch is ``joins_per_round`` plus the active scenario phase's
  ``join_burst``, clipped to what the schedule has left; the cursor (the
  number admitted so far) is read off the state on the device;
- each joiner draws ``attach_m`` distinct targets by preferential
  attachment over the realized degrees: Gumbel-top-k over the masked log
  degrees, drawn from ``fold_in(state.rng, GROWTH_STREAM_SALT)`` at the
  global ``(max_batch, N)`` shape every round;
- the admitted rows go live, record their bootstrap in the registry planes
  (``join_round``, ``admitted_by``), and their fresh edges ride the churn
  re-wiring plane, with ``degree_credit`` counting the edges' far ends.

The draw and the top-k run in row chunks of at most
:data:`DRAW_CHUNK_WORDS` words: each row's top-k is its own, and the draw
takes a counter offset, so every chunk size gives the same bits.

Every function takes ``held``, the ``core.rows.Rows`` the planes hold. On
a process of a mesh over several processes (a block of the swarm's rows,
which are the draw's columns) the draw is the process's column block of
every batch row, each process ranks its own candidates, and the batch
rows' top-m of the union of every process's top-m keys (one all-gather of
``(max_batch, m)`` int64 keys a process) is the whole row's: exact, ties
included, since a key holds the global index. The admission count and the
tail count sum over the processes, and the gamma's float sum is each
process's float64 partial added in rank order; the batch and its targets
are the same on every process, so each sets the batch rows it holds and
credits the targets it holds. The
Gumbel values are ``prng.gumbel``'s (XLA's float32 ``log``, tabulated),
the log degrees ``prng.xla_log``'s, and the top-k breaks ties by the
lower index as ``jax.lax.top_k`` does (:func:`gumbel_top_k`). Every
scatter is order-free (distinct rows, or an integer add), so the card's
bits equal the CPU's.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.state import saturate_round
from tpu_gossip_torch.core.streams import GROWTH_STREAM_SALT
from tpu_gossip_torch.core.topology import hill_gamma

__all__ = [
    "GROWTH_STREAM_SALT",
    "DRAW_CHUNK_WORDS",
    "draw_chunk_rows",
    "realized_degrees",
    "hill_gamma_device",
    "gumbel_top_k",
    "admission_batch",
    "attach_log_degrees",
    "admit",
    "apply_growth",
]

# the most Gumbel words one chunk of the admission draw holds, by device
# type (each word costs about 60 bytes of temporaries through the threefry
# chain and the top-k key): 2^24 words bound a chunk on the card near
# 1 GB; the CPU's chunks stay small enough for its allocator to reuse
# their memory instead of mapping fresh pages every chunk
DRAW_CHUNK_WORDS = {"cuda": 1 << 24, "cpu": 1 << 18}

_M32 = 0xFFFFFFFF
# the order-preserving int32 image of float32 -inf: 0xFF800000 ^ 0x7FFFFFFF
_NEG_INF_IMAGE = -2139095041
# below every candidate's key (:func:`_score_keys`)
_NO_KEY = -(1 << 63)


def realized_degrees(row_ptr, exists, rewired, rewire_targets, degree_credit, lo: int = 0) -> torch.Tensor:
    """The degree vector a preferential-attachment draw weighs (int32):
    a re-wired row counts its valid fresh targets, any other member its
    CSR degree, non-members 0; plus ``degree_credit``, the far ends of
    unfolded fresh edges. The planes hold the swarm's rows from ``lo``
    on; the CSR is the whole swarm's."""
    n = exists.shape[0]
    base = (row_ptr[lo + 1: lo + n + 1] - row_ptr[lo: lo + n]).to(torch.int32)
    fresh = (rewire_targets >= 0).sum(dim=1, dtype=torch.int32)
    own = torch.where(rewired, fresh, base)
    return torch.where(exists, own, 0).to(torch.int32) + degree_credit


def hill_gamma_device(deg: torch.Tensor, live: torch.Tensor, d_min: int, rows=ALL_ROWS) -> torch.Tensor:
    """Running Hill/CSN gamma over the live degree vector (float32 0-d):
    ``1 + k / sum(log(d / (d_min - 1/2)))`` over ``d >= d_min``, 0.0 when
    the tail has under 10 samples. The one float reduction of the plane:
    the logs are XLA's, the sum runs in float64 and rounds once, so it
    stays within float32 reduction tolerance of JAX's sum. Over ``rows``
    the tail count is an integer sum and the float64 partials add in rank
    order before the one rounding."""
    tail = live & (deg >= d_min)
    k = rows.sum(tail.sum(dtype=torch.int32), label="gamma")
    ratio = torch.clamp(deg, min=1).to(torch.float32) / torch.tensor(d_min - 0.5, dtype=torch.float32)
    logs = torch.where(tail, prng.xla_log(ratio), 0.0)
    s = rows.fsum(logs.sum(dtype=torch.float64), label="gamma").to(torch.float32)
    gamma = hill_gamma(k.to(torch.float32), s).to(torch.float32)
    return torch.where((k >= 10) & (s > 0), gamma, torch.zeros_like(gamma))


def _score_keys(scores: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """One int64 key a candidate of float32 ``scores`` rows whose columns
    are the swarm's from ``lo`` on: the score's order-preserving int32
    image above the complemented global index, so every key is distinct
    and a larger key is a larger score or, on a tie, a lower index."""
    b = scores.view(torch.int32)
    # graftlint: disable=mem-widening-cast -- the score's int64 sort key orders as JAX's top_k does
    image = torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)
    idx = torch.arange(lo, lo + scores.shape[1], dtype=torch.int64, device=scores.device)
    return (image << 32) | (_M32 - idx)


def _from_keys(top: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(finite, index)`` of top keys (:func:`_score_keys`)."""
    return (top >> 32) != _NEG_INF_IMAGE, (_M32 - (top & _M32)).to(torch.int32)


def _top_k_tie_low(scores: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(scores, m)`` over float32 rows: ``(finite, index)``
    of each row's ``m`` largest, largest first, ties to the lower index
    and ``-0.0`` below ``+0.0`` (XLA's total order), on the int64 keys of
    :func:`_score_keys`."""
    return _from_keys(torch.topk(_score_keys(scores), m, dim=1).values)


def draw_chunk_rows(n: int, device) -> int:
    """Rows of an ``(rows, n)`` admission draw a chunk holds on ``device``:
    as many as fit its :data:`DRAW_CHUNK_WORDS`, at least one."""
    return max(1, DRAW_CHUNK_WORDS[torch.device(device).type] // max(n, 1))


def gumbel_top_k(key: torch.Tensor, log_deg: torch.Tensor, rows: int, m: int,
                 chunk_rows: int | None = None, held=ALL_ROWS) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(log_deg[None, :] + jax.random.gumbel(key, (rows,
    n)), m)`` as ``(finite (rows, m) bool, targets (rows, m) int32)``,
    drawn and ranked ``chunk_rows`` rows at a time (default:
    :func:`draw_chunk_rows`). ``log_deg`` holds the columns of ``held``
    (``core.rows``): the draw is their block of each row, and the rows'
    top-m is taken over every holder's top-m keys."""
    n = log_deg.shape[0]
    n_all, lo = held.total(n), held.lo
    if chunk_rows is None:
        chunk_rows = draw_chunk_rows(n, log_deg.device)
    keys = []
    for r0 in range(0, rows, chunk_rows):
        r1 = min(rows, r0 + chunk_rows)
        # graftlint: disable=key-linearity -- each chunk draws its own counter block (offset) of the one (rows, n) draw
        g = prng.gumbel(key, (r1 - r0, n), offset=r0 * n_all + lo, row_stride=n_all)
        top = torch.topk(_score_keys(log_deg[None, :] + g, lo), min(m, n), dim=1).values
        # a block narrower than m fills its keys with the least int64
        keys.append(torch.nn.functional.pad(top, (0, m - top.shape[1]), value=_NO_KEY))
    union = held.stack(torch.cat(keys), label="growth")  # (holders, rows, m)
    return _from_keys(torch.topk(torch.cat(tuple(union), dim=1), m, dim=1).values)


def _set_rows(plane: torch.Tensor, sel: torch.Tensor, value) -> torch.Tensor:
    """``plane.at[sel].set(value, mode="drop")`` along axis 0: rows equal
    to ``len(plane)`` are dropped. The kept rows are distinct."""
    n = plane.shape[0]
    ext = torch.cat([plane, plane[:1]])
    ext[sel] = value if isinstance(value, torch.Tensor) else torch.tensor(value, dtype=plane.dtype,
                                                                            device=plane.device)
    return ext[:n]


def admission_batch(growth, exists: torch.Tensor, join_burst: torch.Tensor, held=ALL_ROWS):
    """The round's batch: ``(rows (max_batch,) int64, live (max_batch,)
    bool)``, the swarm's rows at the schedule cursor (the number the state
    says are admitted, counted over the rows of ``held``) and which of
    them this round admits: the quota ``joins_per_round + join_burst``
    clipped to what is left. On the device, with no host read."""
    jb = growth.max_batch
    admitted = held.block(growth.growable, exists.shape[0]) & exists
    n_adm = held.sum(admitted.sum(dtype=torch.int64), label="growth")
    quota = growth.joins_per_round + join_burst.to(torch.int64)
    take = torch.clamp(torch.minimum(quota, growth.total - n_adm), 0, jb)
    lanes = torch.arange(jb, dtype=torch.int64, device=exists.device)
    return growth.admit_rows[n_adm + lanes].to(torch.int64), lanes < take


def attach_log_degrees(row_ptr, exists, alive, declared_dead, rewired, rewire_targets,
                       degree_credit, lo: int = 0) -> torch.Tensor:
    """The float32 log degrees a joiner's draw weighs: ``log(deg)`` of
    each live, undeclared member with a positive realized degree, -inf
    elsewhere (this round's joiners are not members yet, so same-round
    joiners never pick each other); the planes' rows from ``lo`` on."""
    deg = realized_degrees(row_ptr, exists, rewired, rewire_targets, degree_credit, lo)
    attach_ok = exists & alive & ~declared_dead & (deg > 0)
    return torch.where(attach_ok, prng.xla_log(torch.clamp(deg, min=1).to(torch.float32)), float("-inf"))


def admit(growth, rows, batch_live, finite, targets, rnd, *, exists, alive, silent, last_hb, declared_dead,
          rewired, rewire_targets, join_round, admitted_by, degree_credit, held=ALL_ROWS) -> dict:
    """The admission's scatters: the batch rows go live and record their
    bootstrap (``join_round``, ``admitted_by`` = the top-scored target),
    their valid targets become fresh edges on the re-wiring plane, and
    each target gains one ``degree_credit``. The planes hold the rows of
    ``held`` (``core.rows``): the batch rows they hold are set and the
    rest dropped (row ``n``, as the dead tail of the batch); every holder
    knows every target, so each scatters the whole credit and keeps its
    block, with nothing sent."""
    n = exists.shape[0]
    dev = exists.device
    jb, m = growth.max_batch, growth.attach_m
    t_valid = batch_live[:, None] & finite
    seed_id = torch.where(t_valid[:, 0], targets[:, 0], -1)
    mine = batch_live & (rows >= held.lo) & (rows < held.lo + n)
    sel = torch.where(mine, rows - held.lo, n)
    exists = _set_rows(exists, sel, True)
    alive = _set_rows(alive, sel, True)
    silent = _set_rows(silent, sel, False)
    declared_dead = _set_rows(declared_dead, sel, False)
    last_hb = _set_rows(last_hb, sel, saturate_round(rnd, last_hb.dtype))
    # join_round is the int16 registry plane: the round saturates at
    # ROUND_CAP rather than wrapping into the -1 never-joined sentinel
    join_round = _set_rows(join_round, sel, saturate_round(rnd, join_round.dtype))
    admitted_by = _set_rows(admitted_by, sel, seed_id.to(admitted_by.dtype))
    fresh_tg = torch.full((jb, rewire_targets.shape[1]), -1, dtype=rewire_targets.dtype, device=dev)
    fresh_tg[:, :m] = torch.where(t_valid, targets, -1).to(rewire_targets.dtype)
    rewired = _set_rows(rewired, sel, True)
    rewire_targets = _set_rows(rewire_targets, sel, fresh_tg)
    n_all = held.total(n)
    flat_t = torch.where(t_valid, targets.to(torch.int64), n_all).reshape(-1)
    credit = torch.zeros(n_all + 1, dtype=degree_credit.dtype, device=dev)
    credit.index_add_(0, flat_t, torch.ones_like(flat_t, dtype=degree_credit.dtype))
    return dict(
        exists=exists,
        alive=alive,
        silent=silent,
        last_hb=last_hb,
        declared_dead=declared_dead,
        rewired=rewired,
        rewire_targets=rewire_targets,
        join_round=join_round,
        admitted_by=admitted_by,
        degree_credit=degree_credit + held.block(credit, n),
    )


def apply_growth(growth, rng: torch.Tensor, rnd: torch.Tensor, join_burst: torch.Tensor, *,
                 row_ptr, exists, alive, silent, last_hb, declared_dead, rewired, rewire_targets,
                 join_round, admitted_by, degree_credit, chunk_rows: int | None = None, held=ALL_ROWS) -> dict:
    """Admit one round's join batch; returns the ten updated row-level
    fields.

    ``rng`` is the round's root key (``state.rng``): the growth stream is
    ``fold_in(rng, GROWTH_STREAM_SALT)`` and takes nothing of the
    protocol's 5-way split. ``join_burst`` is the active scenario phase's
    extra admissions (0 without one). ``growth.max_batch`` rows are drawn
    every round whatever the take, so stream positions depend on the round
    alone; a round with nothing left to admit changes nothing. Nothing is
    read back to the host. The planes hold the rows of ``held``
    (``core.rows``)."""
    if growth.attach_m > rewire_targets.shape[1]:
        raise ValueError(
            f"growth.attach_m={growth.attach_m} exceeds the state's "
            f"rewire_targets width {rewire_targets.shape[1]} — growth "
            "edges ride the re-wiring plane; build the config with "
            f"rewire_slots >= {growth.attach_m}"
        )
    rows, batch_live = admission_batch(growth, exists, join_burst, held)
    log_deg = attach_log_degrees(row_ptr, exists, alive, declared_dead, rewired, rewire_targets, degree_credit,
                                 held.lo)
    finite, targets = gumbel_top_k(prng.fold_in(rng, GROWTH_STREAM_SALT), log_deg, growth.max_batch,
                                   growth.attach_m, chunk_rows, held)
    return admit(growth, rows, batch_live, finite, targets, rnd, exists=exists, alive=alive, silent=silent,
                 last_hb=last_hb, declared_dead=declared_dead, rewired=rewired, rewire_targets=rewire_targets,
                 join_round=join_round, admitted_by=admitted_by, degree_credit=degree_credit, held=held)
