"""Device-resident serving loop: the example3 flow with ZERO per-frame
host synchronization and micro-chained dispatch.

Beyond the reference (whose sequence loop syncs with the host every
frame): the whole select -> (track -> replace-lost)* recurrence runs as
device programs (models/device_sequence), frames are advanced ``CHAIN``
at a time in one dispatched program each, and the track table + metrics
are pulled once at the end. This is the BASELINE config-2 serving path;
chaining amortizes the per-dispatch cost over ``chain`` frames.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyfeaturetrack_tpu.config import create_config  # noqa: E402
from pyfeaturetrack_tpu.models.device_sequence import (  # noqa: E402
    track_sequence_device)
from pyfeaturetrack_tpu.models.sequence import metrics_from_table  # noqa: E402
from pyfeaturetrack_tpu.utils.io import pgm_read  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
N_FEATURES = 150
N_FRAMES = 10
CHAIN = 3  # frames per dispatched program


def main(out_dir="."):
    if not os.path.exists(os.path.join(DATA, "img0.pgm")):
        import gen_data
        gen_data.main()
    frames = [pgm_read(os.path.join(DATA, f"img{i}.pgm"))
              for i in range(N_FRAMES)]

    cfg = create_config(sequentialMode=True)
    x, y, val = track_sequence_device(frames, cfg=cfg,
                                      n_features=N_FEATURES,
                                      replace_lost=True, chain=CHAIN)
    for i, m in enumerate(metrics_from_table(x, y, val)):
        print(f"frame {i}: {m['n_live']} live"
              + (f", {m['n_refilled']} refilled" if m["n_refilled"]
                 else ""))
    full = (val >= 0).all(axis=0).sum()
    print(f"{full} features survive all {N_FRAMES} frames "
          f"(chain={CHAIN}, zero per-frame host sync)")

    # Push-style live serving: the same math, but frames arrive one at
    # a time (a camera/decoder) and are shipped 8-bit — 4x less host
    # link traffic; the f32 cast fuses into the jitted step. drain()
    # returns-and-releases rows, bounding memory on unbounded streams.
    from pyfeaturetrack_tpu import StreamingTracker  # noqa: E402
    tr = StreamingTracker(cfg, n_features=N_FEATURES, chain=CHAIN)
    for f in frames:
        tr.feed(f)   # uint8 ndarray straight from pgm_read
    sx, sy, sval = tr.drain()
    assert (sval == val).all() and abs(sx - x).max() < 1e-4
    print(f"streaming feed matches: {int((sval[-1] >= 0).sum())} live "
          "on the final frame")
    return x, y, val


if __name__ == "__main__":
    main()
