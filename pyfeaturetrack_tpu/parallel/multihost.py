"""Multi-host deployment helpers.

SURVEY.md section 5.8: across hosts the framework uses standard JAX
multi-controller SPMD — every host runs the same program,
``jax.distributed.initialize`` wires the slice together, and the mesh in
parallel/sharding.py then spans all hosts' devices (collectives ride NVLink
within a host, the network across hosts).

Work placement for the tracker:

* frame-pair / feature sharding: just build the mesh over
  ``jax.devices()`` after ``initialize_cluster`` — jit shardings do the
  rest (data must be loaded per-host with
  ``jax.make_array_from_process_local_data``).
* chunked sequences (models/chunked.py): each host tracks the chunks in
  ``host_chunk_assignment`` locally (the serial per-chunk path or the
  batched lockstep path), then the [N, 3] boundary feature lists are
  gathered host-to-host (process_allgather) and stitched once.
* distributed BA: shard landmarks over the global mesh
  (sfm/ba.py bundle_adjust(mesh=...)) — the camera-block psum is the
  only cross-host collective per iteration.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize_cluster(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       auto: bool = True) -> dict:
    """Bring up JAX multi-controller mode.

    With explicit arguments they are passed straight to
    ``jax.distributed.initialize``. With no arguments and ``auto=True``,
    auto-detection is ATTEMPTED (SLURM and similar schedulers populate the needed
    environment); single-process runs where detection finds no cluster
    fall through cleanly. Returns a summary dict.
    """
    if (coordinator_address is not None or num_processes is not None
            or process_id is not None):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    elif auto:
        try:
            jax.distributed.initialize()
        except Exception:
            pass  # no cluster detected: single-process mode
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def host_chunk_assignment(n_chunks: int) -> list[int]:
    """Chunk indices this host owns (contiguous block partition)."""
    p, n = jax.process_index(), jax.process_count()
    per = n_chunks // n
    extra = n_chunks % n
    start = p * per + min(p, extra)
    count = per + (1 if p < extra else 0)
    return list(range(start, start + count))


def allgather_boundary_states(local_states: np.ndarray,
                              n_chunks: int | None = None):
    """All-gather per-chunk boundary feature arrays across hosts.

    ``local_states``: [n_local_chunks, N, 3] float32 (this host's chunks,
    in host_chunk_assignment order); ``n_chunks``: global chunk count
    (defaults to this host's count x process_count, which is only correct
    for even partitions). Returns the concatenated [n_chunks, N, 3] array
    on every host.

    Uneven partitions are handled by padding every host's contribution to
    the per-host maximum (derivable locally from ``n_chunks`` — the block
    partition is deterministic), gathering even-shaped tiles, then
    dropping the pad rows.
    """
    local_states = np.asarray(local_states)
    n = jax.process_count()
    if n == 1:
        return local_states
    if n_chunks is None:
        n_chunks = local_states.shape[0] * n
    from jax.experimental import multihost_utils

    per_max = -(-n_chunks // n)  # ceil: the largest per-host count
    pad = per_max - local_states.shape[0]
    if pad:
        local_states = np.concatenate(
            [local_states,
             np.zeros((pad,) + local_states.shape[1:],
                      local_states.dtype)], axis=0)
    gathered = np.asarray(multihost_utils.process_allgather(
        local_states, tiled=True)).reshape(
            (n, per_max) + local_states.shape[1:])
    # reassemble, dropping each host's pad rows (counts are deterministic)
    per = n_chunks // n
    extra = n_chunks % n
    parts = [gathered[p, :per + (1 if p < extra else 0)] for p in range(n)]
    return np.concatenate(parts, axis=0)


def track_sequence_multiprocess(frames, cfg=None, n_features: int = 150,
                                n_chunks: int | None = None,
                                replace_lost: bool = True,
                                stitch_tol: float = 1.0):
    """Multi-process chunk-and-stitch sequence tracking (SURVEY.md
    §5.7): every process tracks only the chunks in
    ``host_chunk_assignment``, the per-chunk tables travel host-to-host
    with ONE all-gather, and every process stitches the identical
    global table with models/chunked.stitch_chunk_tables — the same
    function the single-process driver uses, so
    track_sequence_multiprocess(frames) == track_sequence_chunked(
    frames) bit-for-bit (asserted e2e by tests/test_multiprocess.py on
    a real 4-process jax.distributed cluster).

    ``frames`` must be the FULL sequence on every process (frames are
    inputs, not device state; a deployment would read each chunk's
    files per-host — only the chunk bounds matter here). Returns
    (table, col_ids) like the single-process driver (metrics are
    per-host, not gathered).
    """
    from ..models.chunked import (chunk_bounds, stitch_chunk_tables)
    from ..models.sequence import track_sequence

    frames = list(frames)
    n_frames = len(frames)
    if n_chunks is None:
        n_chunks = jax.process_count()
    bounds = chunk_bounds(n_frames, n_chunks)
    mine = host_chunk_assignment(len(bounds))

    # track my chunks; pad every table to the global max chunk length
    # so the all-gather ships one even-shaped [my_chunks, L, N, 3] tile
    max_len = max(e - s for (s, e) in bounds)
    local = np.full((len(mine), max_len, n_features, 3), -1.0,
                    np.float32)
    for row, k in enumerate(mine):
        s, e = bounds[k]
        ft, _ = track_sequence(frames[s:e], cfg=cfg,
                               n_features=n_features,
                               replace_lost=replace_lost)
        ln = e - s
        local[row, :ln, :, 0] = np.asarray(ft.x, np.float32)
        local[row, :ln, :, 1] = np.asarray(ft.y, np.float32)
        local[row, :ln, :, 2] = np.asarray(ft.val, np.float32)

    flat = local.reshape(len(mine), max_len * n_features * 3)
    gathered = allgather_boundary_states(flat, n_chunks=len(bounds))
    gathered = gathered.reshape(len(bounds), max_len, n_features, 3)

    chunk_tables = []
    for k, (s, e) in enumerate(bounds):
        ln = e - s
        chunk_tables.append((s, e,
                             gathered[k, :ln, :, 0].astype(np.float64),
                             gathered[k, :ln, :, 1].astype(np.float64),
                             gathered[k, :ln, :, 2].astype(np.int64)))
    return stitch_chunk_tables(chunk_tables, n_frames, n_features,
                               stitch_tol)
