"""pyfeaturetrack_tpu — KLT feature tracking + SfM front-end in JAX.

A JAX/XLA/Pallas framework with the capabilities of
TimSC/PyFeatureTrack (the Python port of Birchfield's KLT v1.3.4):
Gaussian pyramids, derivative-of-Gaussian gradients, Shi-Tomasi
min-eigenvalue feature selection with min-distance suppression, batched
pyramidal iterative Lucas-Kanade tracking with the full status-code model,
lost-feature replacement, affine-consistency checking, feature list/table
persistence — plus a pose-graph / bundle-adjustment back-end and
multi-device sharding, which the reference does not have.

Design: arrays of features are the unit of work; all state is immutable
pytrees; the tracking context is a static hashable config. See SURVEY.md.
"""

from .config import (  # noqa: F401
    TrackerConfig,
    change_pyramid,
    create_config,
    print_config,
    update_border,
)
from .errors import KLTError, KLTSetVerbosity, KLTWarning  # noqa: F401
from .features import (  # noqa: F401
    KLT_FB_INCONSISTENT,
    KLT_LARGE_RESIDUE,
    KLT_MAX_ITERATIONS,
    KLT_NOT_FOUND,
    KLT_OOB,
    KLT_SMALL_DET,
    KLT_TRACKED,
    FeatureState,
    FeatureTable,
    count_remaining_features,
)

from .models import (  # noqa: F401
    KLTChangeTCPyramid,
    KLTCountRemainingFeatures,
    KLTCreateFeatureList,
    KLTCreateFeatureTable,
    KLTCreateTrackingContext,
    KLTExtractFeatureList,
    KLTPrintTrackingContext,
    KLTReplaceLostFeatures,
    KLTSelectGoodFeatures,
    KLTStoreFeatureList,
    KLTTrackFeatures,
    KLTUpdateTCBorder,
    SequenceTracker,
    Tracker,
    track_sequence,
    track_sequence_chunked,
)
from .models.device_sequence import track_sequence_device  # noqa: F401
from .ops.flow import (  # noqa: F401
    DenseFlow,
    compute_dense_flow,
    dense_flow_fb,
    dense_flow_pyramids,
    flow_consistency,
    flow_to_rgb,
    warp_image,
)
from .ops.disparity import (  # noqa: F401
    DenseDisparity,
    dense_depth,
    dense_disparity,
    dense_disparity_lr,
    dense_disparity_pyramids,
    disparity_lr_consistency,
)
from .ops.track import track_features_pyramids_fb  # noqa: F401
from .serving import (  # noqa: F401
    BatchedStreamingTracker,
    StreamingTracker,
    prefetch_to_device,
    serve_stream,
)
from .utils.loader import FrameLoader, load_frames  # noqa: F401

__version__ = "0.1.0"
