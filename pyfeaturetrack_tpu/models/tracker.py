"""High-level tracker API.

This module is the compatibility surface for users of the reference: every
public ``KLT*`` entry point of TimSC/PyFeatureTrack (klt.py,
selectGoodFeatures.py, trackFeatures.py, storeFeatures.py) has a same-named
function here with matching semantics, plus an idiomatic object API
(``Tracker``) that carries the functional state (config + sequential-mode
pyramid cache) explicitly.

Reference parity map:
  KLTCreateTrackingContext -> config.create_config     (klt.py)
  KLTSelectGoodFeatures    -> ops/select.py            (selectGoodFeatures.py)
  KLTReplaceLostFeatures   -> ops/select.py            (selectGoodFeatures.py)
  KLTTrackFeatures         -> ops/track.py (+affine)   (trackFeatures.py)
  KLTCreateFeatureList/Table, KLTStoreFeatureList, KLTExtractFeatureList,
  KLTCountRemainingFeatures -> features.py             (klt.py/storeFeatures.py)
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import TrackerConfig, create_config
from ..features import (FeatureState, FeatureTable, count_remaining_features,
                        create_feature_list, create_feature_table,
                        extract_feature_list, store_feature_list)
from ..ops.select import replace_lost_features, select_good_features
from ..ops.track import (TrackPyramids, build_track_pyramids_jit,
                         track_features)
from ..utils.staging import stage_f32

# ---------------------------------------------------------------------------
# Reference-shaped functional API
# ---------------------------------------------------------------------------

def KLTCreateTrackingContext(**overrides) -> TrackerConfig:
    """Reference parity: klt.py -> KLTCreateTrackingContext."""
    return create_config(**overrides)


def KLTCreateFeatureList(n_features: int, **kw) -> FeatureState:
    """Reference parity: klt.py -> KLTCreateFeatureList."""
    return create_feature_list(n_features, **kw)


def KLTCreateFeatureTable(n_frames: int, n_features: int) -> FeatureTable:
    """Reference parity: storeFeatures.py -> KLTCreateFeatureTable."""
    return create_feature_table(n_frames, n_features)


def KLTSelectGoodFeatures(cfg: TrackerConfig, img, n_features: int
                          ) -> FeatureState:
    """Reference parity: selectGoodFeatures.py -> KLTSelectGoodFeatures."""
    return select_good_features(img, n_features, cfg)


def KLTReplaceLostFeatures(cfg: TrackerConfig, img, fl: FeatureState
                           ) -> FeatureState:
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures."""
    return replace_lost_features(img, fl, cfg)


def KLTChangeTCPyramid(cfg: TrackerConfig, search_range: int = 15
                       ) -> TrackerConfig:
    """Reference parity: klt.py -> KLTChangeTCPyramid (returns a new
    config instead of mutating)."""
    from ..config import change_pyramid, update_border
    return update_border(change_pyramid(cfg, search_range))


def KLTUpdateTCBorder(cfg: TrackerConfig) -> TrackerConfig:
    """Reference parity: klt.py -> KLTUpdateTCBorder."""
    from ..config import update_border
    return update_border(cfg)


def KLTPrintTrackingContext(cfg: TrackerConfig) -> str:
    """Reference parity: klt.py -> KLTPrintTrackingContext."""
    from ..config import print_config
    return print_config(cfg)


def KLTTrackFeatures(cfg: TrackerConfig, img1, img2, fl: FeatureState,
                     pyramid_last: Optional[TrackPyramids] = None
                     ) -> tuple[FeatureState, TrackPyramids]:
    """Reference parity: trackFeatures.py -> KLTTrackFeatures.

    In the reference, sequential mode stashes frame-2 pyramids on the
    mutable context; here they are returned and passed back explicitly
    (``pyramid_last``). When ``cfg.affineConsistencyCheck >= 0`` the affine
    consistency stage runs after translational tracking.
    """
    from ..errors import KLTError
    # shape-only check: no np.asarray here (it would pull device arrays
    # to host)
    s1 = getattr(img1, "shape", None)
    s2 = getattr(img2, "shape", None)
    if s1 is not None and s2 is not None and tuple(s1) != tuple(s2):
        raise KLTError(
            f"(KLTTrackFeatures) frame size mismatch: {s1} vs {s2}")
    cfgv = cfg.validated_window()
    pyr1 = pyramid_last
    if pyr1 is None:
        pyr1 = build_track_pyramids_jit(stage_f32(img1), cfgv)
    fl_after, pyr2 = track_features(img1, img2, fl, cfgv, pyr1=pyr1)
    if cfgv.affineConsistencyCheck >= 0:
        from ..ops.affine import affine_consistency_check
        fl_after = affine_consistency_check(pyr1, pyr2, fl, fl_after, cfgv)
    return fl_after, pyr2


def KLTStoreFeatureList(fl: FeatureState, ft: FeatureTable, frame: int
                        ) -> FeatureTable:
    """Reference parity: storeFeatures.py -> KLTStoreFeatureList."""
    return store_feature_list(fl, ft, frame)


def KLTExtractFeatureList(ft: FeatureTable, frame: int) -> FeatureState:
    """Reference parity: storeFeatures.py -> KLTExtractFeatureList."""
    return extract_feature_list(ft, frame)


def KLTCountRemainingFeatures(fl: FeatureState) -> int:
    """Reference parity: klt.py -> KLTCountRemainingFeatures."""
    return int(count_remaining_features(fl))


# ---------------------------------------------------------------------------
# Idiomatic object API
# ---------------------------------------------------------------------------

class Tracker:
    """Stateful convenience wrapper: config + sequential-mode pyramid cache.

    The equivalent of holding a reference ``KLT_TrackingContext`` with
    ``sequentialMode = True`` — but the carried state is explicit and the
    underlying compute is the jitted functional path.
    """

    def __init__(self, cfg: Optional[TrackerConfig] = None, **overrides):
        self.cfg = cfg if cfg is not None else create_config(**overrides)
        self._cache: Optional[TrackPyramids] = None
        self._prev_img = None

    def select(self, img, n_features: int) -> FeatureState:
        img = np.asarray(img)
        self._prev_img = img
        if self.cfg.sequentialMode:
            self._cache = build_track_pyramids_jit(
                stage_f32(img), self.cfg.validated_window())
        return select_good_features(img, n_features, self.cfg)

    def track(self, img, fl: FeatureState,
              prev_img=None) -> FeatureState:
        """Track ``fl`` from the previous frame into ``img``."""
        img = np.asarray(img)
        img1 = prev_img if prev_img is not None else self._prev_img
        if img1 is None:
            raise ValueError("track() before select(): no previous frame")
        # the cached pyramids belong to self._prev_img; an explicit
        # prev_img overrides the carried frame, so the cache must not be
        # used (it would silently track from a different image)
        cache = (self._cache if self.cfg.sequentialMode
                 and prev_img is None else None)
        fl, pyr2 = KLTTrackFeatures(self.cfg, img1, img, fl,
                                    pyramid_last=cache)
        if self.cfg.sequentialMode:
            self._cache = pyr2
        self._prev_img = img
        return fl

    def replace_lost(self, img, fl: FeatureState) -> FeatureState:
        return replace_lost_features(np.asarray(img), fl, self.cfg)
