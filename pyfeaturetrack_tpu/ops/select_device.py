"""Fully on-device feature selection / lost-feature replacement.

Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures +
_enforceMinimumDistance (SURVEY.md section 3.1), recomputed as a
device-resident program so a sequence loop with per-frame replacement
never synchronizes with the host.

The reference's greedy best-first acceptance with a mindist occupancy map
is an inherently sequential scan; on device it is recomputed as the
equivalent *lexicographic maximal-independent-set* fixpoint:

* a candidate is ACCEPTED once every higher-priority conflicting
  candidate is rejected,
* and REJECTED once any higher-priority conflicting candidate is
  accepted (or it fails the min-eigenvalue bar / collides with a kept
  pre-existing feature).

Iterating those two rules to fixpoint yields exactly the greedy
acceptance sequence (each round decides at least the highest-priority
undecided candidate), with each round a dense [K, K] boolean relaxation
that is elementwise work over the batch.

Exactness vs the host greedy: the device path considers only the top-K
candidates by eigenvalue (pre-masked against kept features). Greedy is
prefix-stable, so whenever the K-candidate pass fills every free slot the
result is bit-identical to the host scan over ALL candidates; only when
candidates run out inside the top-K (returned as ``exhausted``) can the
full scan find extra features. Pick K large enough for the workload
(tests drive K = all candidates to prove exact equality).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..features import KLT_NOT_FOUND
from .select import selection_eig_map_core

# Suppression keeps boolean [K, K] relaxations; 4096 caps the matrix at
# 16 MB which both fits device memory comfortably and converges in ~10 rounds.
DEFAULT_TOP_K = 4096
# Escalation ladder: selection starts at a small K
# (refills need tens of slots, and lax.top_k + suppression both scale
# with K), then re-runs at 2x/8x under lax.cond whenever the pass
# exhausted its candidates with free slots left AND the candidate pool
# was actually saturated (k-th value above the bar — if not, no larger
# K can find more and the small pass already equals the full greedy).
# Exact at every rung by greedy prefix-stability.
_REFILL_K0 = 512
_ESCALATION_CAP_FACTOR = 4


def _dilate_chebyshev(occ: jax.Array, radius: int) -> jax.Array:
    """Box (Chebyshev-ball) dilation of a boolean occupancy map — the
    device equivalent of the reference's fill_map region stamping."""
    if radius <= 0:
        return occ
    w = 2 * radius + 1
    return lax.reduce_window(occ, False, lax.bitwise_or, (w, w), (1, 1),
                             "SAME")


def _candidate_grid(cfg, shape):
    """Static candidate-lattice geometry (borders + nSkippedPixels)."""
    nrows, ncols = shape
    window_hw = max(cfg.window_width // 2, 1)
    window_hh = max(cfg.window_height // 2, 1)
    borderx = max(cfg.borderx, window_hw)
    bordery = max(cfg.bordery, window_hh)
    step = cfg.nSkippedPixels + 1
    ny = len(range(bordery, nrows - bordery, step))
    nx = len(range(borderx, ncols - borderx, step))
    return borderx, bordery, step, ny, nx


def suppress_and_fill(cand_x: jax.Array, cand_y: jax.Array,
                      cand_val: jax.Array, valid: jax.Array,
                      free: jax.Array, x: jax.Array, y: jax.Array,
                      val: jax.Array, mindist: int):
    """Greedy mindist suppression over ordered candidates + slot fill.

    ``cand_*``/[K] are priority-ordered candidates (valid[i]=False lanes
    are pre-rejected); ``free``/[N] marks output slots to fill. Returns
    (x, y, val, filled, exhausted): filled marks slots given a fresh
    candidate, exhausted is True when candidates ran out with free slots
    left (the only case where top-K may diverge from the full greedy).
    """
    k = cand_x.shape[0]
    d = mindist - 1  # the reference decrements before stamping

    dx = jnp.abs(cand_x[:, None] - cand_x[None, :])
    dy = jnp.abs(cand_y[:, None] - cand_y[None, :])
    ii = jnp.arange(k)
    # P[i, j]: candidate j conflicts with i and outranks it (j < i)
    P = (dx <= d) & (dy <= d) & (ii[None, :] < ii[:, None])

    def body(state):
        accepted, rejected, _ = state
        rej = rejected | jnp.any(P & accepted[None, :], axis=-1)
        acc = accepted | (~rej & ~jnp.any(P & ~rej[None, :], axis=-1))
        changed = jnp.any(acc != accepted) | jnp.any(rej != rejected)
        return acc, rej, changed

    init = (jnp.zeros((k,), bool), ~valid, jnp.asarray(True))
    accepted, _, _ = lax.while_loop(lambda s: s[2], body, init)
    return fill_slots(accepted, cand_x, cand_y, cand_val, free, x, y,
                      val)


def fill_slots(accepted: jax.Array, cand_x: jax.Array, cand_y: jax.Array,
               cand_val: jax.Array, free: jax.Array, x: jax.Array,
               y: jax.Array, val: jax.Array):
    """Assign the r-th accepted candidate to the r-th free slot, in
    order."""
    k = cand_x.shape[0]
    ii = jnp.arange(k)
    acc_rank = jnp.cumsum(accepted) - 1
    n_acc = jnp.sum(accepted)
    cand_for_rank = jnp.zeros((k,), jnp.int32).at[
        jnp.where(accepted, acc_rank, k)].set(ii.astype(jnp.int32),
                                              mode="drop")
    slot_rank = jnp.cumsum(free) - 1
    ci = cand_for_rank[jnp.clip(slot_rank, 0, k - 1)]
    filled = free & (slot_rank < n_acc)

    new_x = jnp.where(free, jnp.where(filled, cand_x[ci].astype(x.dtype),
                                      -1.0), x)
    new_y = jnp.where(free, jnp.where(filled, cand_y[ci].astype(y.dtype),
                                      -1.0), y)
    new_val = jnp.where(free, jnp.where(filled, cand_val[ci],
                                        KLT_NOT_FOUND), val)
    exhausted = jnp.any(free & ~filled)
    return new_x, new_y, new_val, filled, exhausted


def select_features_device(img: jax.Array, x: jax.Array, y: jax.Array,
                           val: jax.Array, cfg, *,
                           replacing: bool, top_k: int = DEFAULT_TOP_K):
    """On-device (re)selection into the (x, y, val) feature arrays.

    ``replacing=False``: overwrite every slot (KLTSelectGoodFeatures).
    ``replacing=True``: keep val >= 0 slots, refill the rest
    (KLTReplaceLostFeatures). Traceable; shapes/config must be static.

    Returns (x, y, val, filled, exhausted). ``exhausted`` is True only
    when the result MAY diverge from the host full scan: every
    escalation rung (up to 4x top_k) ran dry with free slots left while
    the candidate pool was still saturated. Merely failing to fill all
    slots (pool genuinely dry — the host scan would fail identically)
    does not flag; check ``filled``/``val`` for that.
    """
    eig = selection_eig_map_core(
        jnp.asarray(img, jnp.float32),
        window_width=int(cfg.window_width),
        window_height=int(cfg.window_height),
        smooth_before=bool(cfg.smoothBeforeSelecting),
        smooth_sigma=float(cfg.smooth_sigma),
        grad_sigma=float(cfg.grad_sigma))
    return select_features_from_eig_device(eig, x, y, val, cfg,
                                           replacing=replacing,
                                           top_k=top_k)


def select_features_from_eig_device(eig: jax.Array, x: jax.Array,
                                    y: jax.Array, val: jax.Array, cfg, *,
                                    replacing: bool,
                                    top_k: int = DEFAULT_TOP_K):
    """Selection given a precomputed int32 min-eig map (lets sequence
    loops reuse the tracking pyramid's level-0 gradients)."""
    nrows, ncols = eig.shape
    borderx, bordery, step, ny, nx = _candidate_grid(cfg, eig.shape)
    min_eig = max(int(cfg.min_eigenvalue), 1)

    if ny == 0 or nx == 0:
        # no room for features: mirror the host path's empty-grid
        # handling. Never flags divergence: the host full scan sees the
        # same empty lattice and fills nothing either.
        free = jnp.ones_like(val, bool) if not replacing else (val < 0)
        nf = jnp.where(free, KLT_NOT_FOUND, val)
        return (jnp.where(free, -1.0, x), jnp.where(free, -1.0, y), nf,
                jnp.zeros_like(free), jnp.asarray(False))

    cand = eig[bordery:nrows - bordery:step, borderx:ncols - borderx:step]
    cand = cand[:ny, :nx]

    if replacing:
        free = val < 0
        if int(cfg.mindist) >= 1:
            # Stamp kept features into an occupancy map and dilate it by
            # the mindist radius: candidates inside are rejected before
            # ranking, so the top-K budget is spent only on placeable
            # candidates. mindist == 0 suppresses NOTHING in the host
            # greedy (the decremented radius makes fill_map's box
            # empty), so the pre-mask is skipped there.
            keep = ~free
            xi = jnp.clip(x.astype(jnp.int32), 0, ncols - 1)
            yi = jnp.clip(y.astype(jnp.int32), 0, nrows - 1)
            occ = jnp.zeros((nrows, ncols), bool).at[yi, xi].max(keep)
            blocked = _dilate_chebyshev(occ, int(cfg.mindist) - 1)
            cand_blocked = blocked[bordery:nrows - bordery:step,
                                   borderx:ncols - borderx:step][:ny, :nx]
            cand = jnp.where(cand_blocked, 0, cand)
    else:
        free = jnp.ones_like(val, bool)

    # Candidates below the bar rank last with value 0 (< min_eig >= 1);
    # lax.top_k breaks ties by lower index first = the host path's stable
    # (-val, scan-order) sort.
    flat = jnp.where(cand < min_eig, 0, cand).ravel()
    n_cand = int(flat.shape[0])

    def stage(k):
        """One selection pass over the top-k candidates. Returns the
        fill result plus `saturated`: the pass examined k candidates all
        above the bar while MORE exist beyond k — the only situation in
        which a larger K (or the host full scan) could see candidates
        this pass did not."""
        def run(_):
            top_val, top_idx = lax.top_k(flat, k)
            cand_y = (bordery + (top_idx // nx) * step).astype(jnp.int32)
            cand_x = (borderx + (top_idx % nx) * step).astype(jnp.int32)
            valid = top_val >= min_eig
            nxx, nyy, nval, filled, ran_dry = suppress_and_fill(
                cand_x, cand_y, top_val, valid, free, x, y, val,
                int(cfg.mindist))
            saturated = valid[k - 1] & (k < n_cand)
            return nxx, nyy, nval, filled, ran_dry, saturated
        return run

    # static escalation ladder (see module constants). Initial selection
    # (replacing=False) must seat N features, so it starts at the full
    # top_k as before; a refill typically needs tens, so it starts small.
    k0 = _REFILL_K0 if replacing else int(top_k)
    ladder = sorted({min(k, n_cand) for k in
                     (k0, int(top_k),
                      _ESCALATION_CAP_FACTOR * int(top_k))})

    out = stage(ladder[0])(None)
    for k in ladder[1:]:
        # escalate only when this pass ran out of candidates with slots
        # unfilled AND the pool was saturated at the previous K
        out = lax.cond(out[4] & out[5], stage(k), lambda _: out, None)
    # exhausted = "the result may differ from the host full scan": ran
    # dry at the final rung while candidates beyond it existed. Running
    # dry on an UNsaturated pass means the full scan would also have
    # found nothing more — exact, no flag (a crowded small frame would
    # otherwise warn spuriously here).
    return out[0], out[1], out[2], out[3], out[4] & out[5]


replace_lost_device = functools.partial(jax.jit, static_argnames=(
    "cfg", "replacing", "top_k"))(select_features_device)
