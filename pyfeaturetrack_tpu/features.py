"""Feature data model: SoA feature state + feature table.

Reference parity: klt.py -> KLT_Feature / KLT_FeatureList (here one
structure-of-arrays pytree, FeatureState) and storeFeatures.py ->
KLTCreateFeatureTable / KLTStoreFeatureList / KLTExtractFeatureList
(here FeatureTable).

The reference's per-feature mutable objects become fixed-shape arrays:
``val`` holds the min-eigenvalue after selection (>= 0) and the status code
after tracking, exactly like the reference. Status codes are bit-identical
(klt.py constants):
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

KLT_TRACKED = 0
KLT_NOT_FOUND = -1
KLT_SMALL_DET = -2
KLT_MAX_ITERATIONS = -3
KLT_OOB = -4
KLT_LARGE_RESIDUE = -5
# Beyond-reference extension (the reference stops at -5): forward-
# backward consistency rejection (ops/track.track_features_pyramids_fb).
KLT_FB_INCONSISTENT = -6

STATUS_NAMES = {
    KLT_TRACKED: "tracked",
    KLT_NOT_FOUND: "not_found",
    KLT_SMALL_DET: "small_det",
    KLT_MAX_ITERATIONS: "max_iterations",
    KLT_OOB: "oob",
    KLT_LARGE_RESIDUE: "large_residue",
    KLT_FB_INCONSISTENT: "fb_inconsistent",
}


class AffineState(NamedTuple):
    """Per-feature first-frame template + warp for the consistency check.

    Reference parity: klt.py -> KLT_Feature aff_* fields. Templates are
    exactly affine_window-sized: they are captured by bilinear sampling
    centered on the feature, so the grid is feature-aligned and no
    interpolation border or stored subpixel offset is needed (the
    reference keeps a border because it copies integer-aligned
    sub-images). ``x``/``y`` record the capture anchor position — kept as
    metadata mirroring aff_x/aff_y; the matching math does not read them.
    """
    img: jax.Array        # [N, T, T] template intensities
    gradx: jax.Array      # [N, T, T]
    grady: jax.Array      # [N, T, T]
    x: jax.Array          # [N] capture anchor (frame-1 position)
    y: jax.Array          # [N]
    A: jax.Array          # [N, 2, 2] warp, rows [[Axx, Axy], [Ayx, Ayy]]
    valid: jax.Array      # [N] bool — template captured (aff_img != NULL)


class FeatureState(NamedTuple):
    """Structure-of-arrays feature list (= reference KLT_FeatureList)."""
    x: jax.Array    # [N] float32
    y: jax.Array    # [N] float32
    val: jax.Array  # [N] int32: eigenvalue after select, status after track
    aff: Optional[AffineState] = None

    @property
    def nFeatures(self) -> int:
        return self.x.shape[-1]


def create_feature_list(n_features: int, with_affine: bool = False,
                        tmpl_size: int = 15) -> FeatureState:
    """All slots empty (val = KLT_NOT_FOUND).

    Reference parity: klt.py -> KLTCreateFeatureList.
    """
    aff = None
    if with_affine:
        t = tmpl_size
        aff = AffineState(
            img=jnp.zeros((n_features, t, t), jnp.float32),
            gradx=jnp.zeros((n_features, t, t), jnp.float32),
            grady=jnp.zeros((n_features, t, t), jnp.float32),
            x=jnp.zeros((n_features,), jnp.float32),
            y=jnp.zeros((n_features,), jnp.float32),
            A=jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32),
                               (n_features, 2, 2)),
            valid=jnp.zeros((n_features,), bool),
        )
    return FeatureState(
        x=jnp.full((n_features,), -1.0, jnp.float32),
        y=jnp.full((n_features,), -1.0, jnp.float32),
        val=jnp.full((n_features,), KLT_NOT_FOUND, jnp.int32),
        aff=aff,
    )


def count_remaining_features(fl: FeatureState) -> jax.Array:
    """Number of live features (val >= 0).

    Reference parity: klt.py -> KLTCountRemainingFeatures.
    """
    return jnp.sum(fl.val >= 0)


def reset_affine(aff: AffineState, drop_mask: jax.Array) -> AffineState:
    """Invalidate templates for features in ``drop_mask`` (= the reference
    freeing aff_img and resetting the warp to identity on track loss)."""
    eye = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), aff.A.shape)
    return aff._replace(
        valid=jnp.where(drop_mask, False, aff.valid),
        A=jnp.where(drop_mask[:, None, None], eye, aff.A),
    )


class FeatureTable(NamedTuple):
    """(nFrames x nFeatures) history of (x, y, val).

    Reference parity: storeFeatures.py -> KLT_FeatureTable.
    """
    x: jax.Array    # [F, N] float32
    y: jax.Array    # [F, N] float32
    val: jax.Array  # [F, N] int32

    @property
    def nFrames(self) -> int:
        return self.x.shape[0]

    @property
    def nFeatures(self) -> int:
        return self.x.shape[1]


def create_feature_table(n_frames: int, n_features: int) -> FeatureTable:
    """Reference parity: storeFeatures.py -> KLTCreateFeatureTable."""
    return FeatureTable(
        x=jnp.full((n_frames, n_features), -1.0, jnp.float32),
        y=jnp.full((n_frames, n_features), -1.0, jnp.float32),
        val=jnp.full((n_frames, n_features), KLT_NOT_FOUND, jnp.int32),
    )


def store_feature_list(fl: FeatureState, ft: FeatureTable,
                       frame: int | jax.Array) -> FeatureTable:
    """Write the list into row ``frame`` (functional update).

    Reference parity: storeFeatures.py -> KLTStoreFeatureList.
    """
    return FeatureTable(
        x=ft.x.at[frame].set(fl.x),
        y=ft.y.at[frame].set(fl.y),
        val=ft.val.at[frame].set(fl.val),
    )


def extract_feature_list(ft: FeatureTable, frame: int | jax.Array,
                         template: Optional[FeatureState] = None) -> FeatureState:
    """Read row ``frame`` back into a feature list.

    Reference parity: storeFeatures.py -> KLTExtractFeatureList.
    """
    aff = template.aff if template is not None else None
    return FeatureState(x=ft.x[frame], y=ft.y[frame], val=ft.val[frame], aff=aff)


def feature_state_from_numpy(arr: np.ndarray,
                             aff: Optional[AffineState] = None) -> FeatureState:
    """(N,3) float array of (x, y, val) -> FeatureState."""
    a = np.asarray(arr)
    return FeatureState(
        x=jnp.asarray(a[:, 0], jnp.float32),
        y=jnp.asarray(a[:, 1], jnp.float32),
        val=jnp.asarray(np.asarray(a[:, 2]).astype(np.int64), jnp.int32),
        aff=aff,
    )


def feature_state_to_numpy(fl: FeatureState) -> np.ndarray:
    """FeatureState -> (N,3) float64 array of (x, y, val)."""
    return np.stack([
        np.asarray(fl.x, np.float64),
        np.asarray(fl.y, np.float64),
        np.asarray(fl.val, np.float64),
    ], axis=1)
