"""Chunk-parallel sequence tracking with boundary stitching.

SURVEY.md section 5.7: the true context-parallel analogue for video —
split the sequence into chunks sharing ONE overlap frame, track each chunk
independently (chunks are embarrassingly parallel across chips/hosts; only
the tracker state inside a chunk is serial), then stitch track identities
at the shared boundary frames by matching feature positions.

The output is a global track table: [n_frames, n_tracks] over the union of
stitched identities, equivalent in content to what a single sequential run
over the whole sequence produces (same per-chunk physics; identities that
persist across a boundary are linked when their boundary positions agree
within ``stitch_tol`` pixels).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..config import TrackerConfig, create_config
from .sequence import track_sequence


@functools.lru_cache(maxsize=None)
def _lockstep_programs(cfg: TrackerConfig, replace_lost: bool):
    """Jitted lockstep programs, cached per (cfg, replace_lost) — the jit
    objects must outlive one track_chunks_batched call or every call
    recompiles (~seconds each on the remote compiler).

    State is carried on device between jitted calls; step_k advances k
    frame steps in ONE program. Long in-program chains (scan or deep
    unroll) degrade on the remote-execution backend, but SHORT unrolled
    chains amortize the dispatch floor (DESIGN.md §3a) — the round-1
    cliff came from host-side slicing of stacked outputs, which is why
    step_k returns the final state UNSTACKED."""
    import jax
    import jax.numpy as jnp

    from ..ops.select_device import select_features_from_eig_device
    from ..ops.track import build_track_pyramids, track_features_pyramids
    from .device_sequence import _selection_eig_from_pyr

    @jax.jit
    def first(frame_batch):
        return jax.vmap(lambda im: build_track_pyramids(im, cfg))(
            frame_batch)

    def step_body(pyr_prev, frame_batch, x, y, v):
        pyr_new = jax.vmap(lambda im: build_track_pyramids(im, cfg))(
            frame_batch)
        nx, ny, nv = jax.vmap(
            lambda p1, p2, xx, yy, vv: track_features_pyramids(
                p1, p2, xx, yy, vv, cfg))(pyr_prev, pyr_new, x, y, v)
        ex = jnp.asarray(False)
        if replace_lost:
            # under vmap a cond would run both branches anyway; the
            # refill is an exact identity on chunks with nothing lost
            def refill(img, p2, xx, yy, vv):
                eig = _selection_eig_from_pyr(img, p2, cfg)
                rx, ry, rv, _, exhausted = select_features_from_eig_device(
                    eig, xx, yy, vv, cfg, replacing=True)
                return rx, ry, rv, exhausted
            nx, ny, nv, exs = jax.vmap(refill)(frame_batch, pyr_new,
                                               nx, ny, nv)
            ex = jnp.any(exs)
        return pyr_new, nx, ny, nv, ex

    step = jax.jit(step_body)

    @jax.jit
    def step_k(pyr, frame_batches: tuple, x, y, v):
        hx, hy, hv = [], [], []
        ex = jnp.asarray(False)
        for fb in frame_batches:
            pyr, x, y, v, e = step_body(pyr, fb, x, y, v)
            ex = ex | e
            hx.append(x)
            hy.append(y)
            hv.append(v)
        hist = (jnp.stack(hx, axis=1), jnp.stack(hy, axis=1),
                jnp.stack(hv, axis=1))  # [C, k, N]
        return pyr, hist, (x, y, v), ex

    return first, step, step_k


def track_chunks_batched(chunk_frames: np.ndarray, init_x, init_y, init_val,
                         cfg: TrackerConfig, replace_lost: bool = False,
                         chain: int = 1):
    """Track C equal-length chunks in lockstep: one vmapped device call
    advances EVERY chunk by one frame, so a long video tracks at the
    batched-streams rate instead of the single-stream rate.

    chunk_frames: [C, F, H, W] float frames (chunk c's local frames) — a
    numpy array, or a LIST of F device arrays [C, H, W] pre-staged on
    device (preferred for throughput: the compute path runs ~65 us per
    batched step; host->device transfer of the frames dominates wall
    clock on slow-interconnect rigs).
    init_*: [C, N] initial feature state at each chunk's frame 0.
    Returns (xs, ys, vals, exhausted): [C, F, N] per-frame tracked state
    (frame 0 is the initial selection) plus a DEVICE bool scalar set when
    a refill ran out of top-K candidates (callers should surface it with
    warn_selection_exhausted when they pull the table — pulling it here
    would be a device->host sync that stalls the queued steps,
    DESIGN.md rule 3). Pure device path: no host pulls between
    frames. ``replace_lost=True`` refills lost slots each step with the
    on-device selection (ops.select_device) — reference-complete
    example3 semantics at the multi-stream rate.

    ``chain`` > 1 advances that many frame steps per dispatched program
    (the lockstep analogue of device_sequence.sequence_chain_device),
    amortizing the ~40 us per-dispatch floor across chain x C frames;
    the sub-chain tail runs per-step. Math is identical for any chain.
    """
    import jax.numpy as jnp

    if isinstance(chunk_frames, (list, tuple)):
        f = len(chunk_frames)
    else:
        f = np.shape(chunk_frames)[1]

    first, step, step_k = _lockstep_programs(cfg, bool(replace_lost))

    # Per-step frame batches must be separate contiguous device arrays:
    # slicing a packed [C, F, H, W] device array per step ([:, i]) runs a
    # strided-slice program that is pathologically slow on the remote
    # backend (~770 ms vs ~65 us per step measured).
    if isinstance(chunk_frames, (list, tuple)):
        frame_steps = list(chunk_frames)  # pre-staged by caller
    else:
        chunk_frames = np.asarray(chunk_frames, np.float32)
        frame_steps = [jnp.asarray(np.ascontiguousarray(chunk_frames[:, i]))
                       for i in range(f)]
    x = jnp.asarray(init_x, jnp.float32)
    y = jnp.asarray(init_y, jnp.float32)
    v = jnp.asarray(init_val, jnp.int32)

    pyr = first(frame_steps[0])
    if chain <= 1:
        rows = [(x, y, v)]
        exhausted = jnp.asarray(False)
        for i in range(1, f):
            pyr, x, y, v, ex = step(pyr, frame_steps[i], x, y, v)
            exhausted = exhausted | ex
            rows.append((x, y, v))
        out = tuple(jnp.stack([r[j] for r in rows], axis=1)
                    for j in range(3))
    else:
        # history accumulates as [C, 1, N] rows (single steps) and
        # [C, k, N] blocks (chained calls), concatenated once at the end
        parts = [tuple(a[:, None] for a in (x, y, v))]
        exhausted = jnp.asarray(False)
        i = 1
        while i < f:
            if f - i >= chain:
                pyr, hist, (x, y, v), ex = step_k(
                    pyr, tuple(frame_steps[i + j] for j in range(chain)),
                    x, y, v)
                parts.append(hist)
                i += chain
            else:
                pyr, x, y, v, ex = step(pyr, frame_steps[i], x, y, v)
                parts.append(tuple(a[:, None] for a in (x, y, v)))
                i += 1
            exhausted = exhausted | ex
        out = tuple(jnp.concatenate([p[j] for p in parts], axis=1)
                    for j in range(3))
    return out + (exhausted,)


def chunk_bounds(n_frames: int, n_chunks: int) -> list[tuple[int, int]]:
    """Split [0, n_frames) into chunks sharing one boundary frame:
    [(0, e0), (e0-1+1? ...)] — chunk k spans [s_k, e_k) with
    s_{k+1} = e_k - 1 (the overlap frame)."""
    n_chunks = max(1, min(n_chunks, n_frames - 1))
    # distribute the n_frames-1 transitions evenly
    trans = n_frames - 1
    per = trans // n_chunks
    extra = trans % n_chunks
    bounds = []
    start = 0
    for k in range(n_chunks):
        steps = per + (1 if k < extra else 0)
        end = start + steps + 1
        bounds.append((start, end))
        start = end - 1
    return bounds


def _stitch_ids(prev_xy: np.ndarray, prev_ids: np.ndarray,
                next_xy: np.ndarray, tol: float) -> np.ndarray:
    """Match next-chunk features at the boundary frame to previous global
    ids by nearest position. Returns per-next-feature global id (-1 = new).
    """
    ids = np.full(next_xy.shape[0], -1, np.int64)
    if prev_xy.shape[0] == 0 or next_xy.shape[0] == 0:
        return ids
    d = np.abs(prev_xy[None, :, :] - next_xy[:, None, :]).max(axis=-1)
    best = d.argmin(axis=1)
    ok = d[np.arange(next_xy.shape[0]), best] <= tol
    ids[ok] = prev_ids[best[ok]]
    # a global id must not be claimed twice; keep the closest claimant
    for gid in np.unique(ids[ids >= 0]):
        claimants = np.nonzero(ids == gid)[0]
        if claimants.size > 1:
            keep = claimants[d[claimants, best[claimants]].argmin()]
            ids[claimants] = -1
            ids[keep] = gid
    return ids


def track_sequence_chunked(frames, cfg: Optional[TrackerConfig] = None,
                           n_features: int = 150, n_chunks: int = 2,
                           replace_lost: bool = True,
                           stitch_tol: float = 1.0,
                           batched: bool = False, chain: int = 1):
    # stitch_tol: a continuing physical corner is re-detected by the next
    # chunk at an integer pixel while the left chunk tracked it to subpixel
    # drift — up to 0.5 px apart per axis; 1.0 px catches those without
    # ambiguity (mindist keeps distinct features >= mindist apart).
    """Track ``frames`` in ``n_chunks`` independent chunks and stitch.

    Returns (table, track_ids_per_chunk, metrics):
      table — dict with 'x', 'y', 'val' float/int arrays
      [n_frames, n_global_tracks]; columns are stitched global tracks.
    Chunks are independent after their first frame, so on a multi-host
    deployment each host tracks its own chunk concurrently and only the
    boundary feature lists travel over DCN (one [N, 3] array per boundary).

    ``batched=True`` advances ALL chunks in lockstep with one vmapped
    device call per frame step (aggregate multi-stream throughput on one
    chip); ``replace_lost`` is honored there too via the on-device
    selection (ops.select_device) — no host pulls between frames.
    ``chain`` > 1 (batched mode only) advances that many lockstep steps
    per dispatched program (track_chunks_batched's chain knob).
    """
    frames = list(frames)
    n_frames = len(frames)
    cfg = cfg if cfg is not None else create_config()
    bounds = chunk_bounds(n_frames, n_chunks)

    chunk_tables = []
    all_metrics = []
    if batched:
        from ..ops.select import select_good_features_arrays
        max_len = max(e - s for (s, e) in bounds)
        stack = np.zeros((len(bounds), max_len) + np.shape(frames[0]),
                         np.float32)
        inits = np.zeros((len(bounds), n_features, 3), np.float64)
        for k, (s, e) in enumerate(bounds):
            chunk = frames[s:e]
            stack[k, :len(chunk)] = np.asarray(chunk, np.float32)
            stack[k, len(chunk):] = chunk[-1]  # pad: repeat last frame
            inits[k] = select_good_features_arrays(chunk[0], n_features, cfg)
        xs, ys, vs, exhausted = track_chunks_batched(
            stack, inits[..., 0], inits[..., 1],
            inits[..., 2].astype(np.int64), cfg,
            replace_lost=replace_lost, chain=chain)
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        vs = np.asarray(vs, np.int64)
        if replace_lost and bool(exhausted):  # table already pulled above
            from .device_sequence import warn_selection_exhausted
            from ..ops.select_device import DEFAULT_TOP_K
            warn_selection_exhausted("track_chunks_batched", DEFAULT_TOP_K)
        for k, (s, e) in enumerate(bounds):
            ln = e - s
            chunk_tables.append((s, e, xs[k, :ln], ys[k, :ln], vs[k, :ln]))
            all_metrics.append([])
    else:
        # Track every chunk independently (parallel across hosts in
        # deployment; serial here — the math is identical).
        for (s, e) in bounds:
            ft, metrics = track_sequence(frames[s:e], cfg=cfg,
                                         n_features=n_features,
                                         replace_lost=replace_lost)
            chunk_tables.append((s, e, np.asarray(ft.x, np.float64),
                                 np.asarray(ft.y, np.float64),
                                 np.asarray(ft.val, np.int64)))
            all_metrics.append(metrics)

    table, col_ids = stitch_chunk_tables(chunk_tables, n_frames,
                                         n_features, stitch_tol)
    return (table, col_ids, all_metrics)


def stitch_chunk_tables(chunk_tables, n_frames: int, n_features: int,
                        stitch_tol: float = 1.0):
    """Stitch per-chunk track tables into one global table.

    ``chunk_tables`` is a list of (s, e, x, y, v) with x/y [e-s, N]
    float64 and v [e-s, N] int64, chunks sharing one boundary frame
    (chunk_bounds). Pure host-side numpy — the piece each host runs
    after all-gathering every chunk's table in a multi-process
    deployment (parallel/multihost.track_sequence_multiprocess), and
    the same code single-process callers use, so the two lanes agree
    bit-for-bit by construction. Returns (table dict, col_ids)."""
    next_gid = 0
    col_ids = []       # per chunk: global id of each feature column
    col_matched = []   # per chunk: column continues a previous-chunk track
    for k, (s, e, x, y, v) in enumerate(chunk_tables):
        ids = np.full(n_features, -1, np.int64)
        if k > 0:
            ps, pe, px, py, pv = chunk_tables[k - 1]
            # boundary frame = global frame s == local frame (pe-ps-1) of
            # chunk k-1 and local frame 0 of chunk k
            prev_live = pv[-1] >= 0
            prev_ids = col_ids[k - 1]
            live_mask = prev_live & (prev_ids >= 0)
            prev_xy = np.stack([px[-1][live_mask], py[-1][live_mask]], -1)
            cur_live = v[0] >= 0
            nxt_xy = np.stack([x[0][cur_live], y[0][cur_live]], -1)
            matched = _stitch_ids(prev_xy, prev_ids[live_mask], nxt_xy,
                                  stitch_tol)
            ids[np.nonzero(cur_live)[0]] = matched
        col_matched.append(ids >= 0)
        # assign fresh global ids to unmatched live columns
        for j in range(n_features):
            ever_live = (v[:, j] >= 0).any()
            if ever_live and ids[j] < 0:
                ids[j] = next_gid
                next_gid += 1
        col_ids.append(ids)

    # Merge into the global table.
    gx = np.full((n_frames, next_gid), -1.0)
    gy = np.full((n_frames, next_gid), -1.0)
    gv = np.full((n_frames, next_gid), -1, np.int64)
    for k, (s, e, x, y, v) in enumerate(chunk_tables):
        ids = col_ids[k]
        for j in range(n_features):
            gid = ids[j]
            if gid < 0:
                continue
            # the boundary frame belongs to the LEFT chunk for continued
            # tracks; fresh tracks born at this chunk's first frame keep
            # their first observation (the sequential run records it too)
            lo = 1 if (k > 0 and col_matched[k][j]) else 0
            rows = np.arange(s + lo, e)
            lrows = np.arange(lo, e - s)
            gx[rows, gid] = x[lrows, j]
            gy[rows, gid] = y[lrows, j]
            gv[rows, gid] = v[lrows, j]

    return {"x": gx, "y": gy, "val": gv}, col_ids
