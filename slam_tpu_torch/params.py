"""Runtime parameters and derived static settings (the port's copy of
slam_tpu/params.py, same names and layout, without what the port does not
use: the per-level sigma^2 and ``StaticSettings.replace``; the port imports
nothing of slam_tpu).

Equivalent of the reference's externally-defined
``odometry::ParametersSlam`` knob struct (the ~60 fields enumerated in
SURVEY.md §2.12, referenced throughout the reference sources) plus
``slam::StaticSettings`` (reference: static_settings.{hpp,cpp}).

All defaults follow the semantics visible in the reference code; fields keep
the reference's names so a user of the reference can map their configuration
1:1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class ParametersSlam:
    # --- ORB front-end -----------------------------------------------------
    orbScaleLevels: int = 8
    orbScaleFactor: float = 1.2
    orbLkTrackLevel: int = 1          # pyramid level for LK-tracked keypoints
    maxKeypoints: int = 1000
    slamFeatureDetector: str = ""     # "" = default (gftt); "fast" supported
    useGpuImagePyramid: bool = True   # here: use the TPU pyramid kernel
    gfttMinDistance: float = 7.0      # from the tracker parameter set (feature_detector.cpp:81)

    # --- threading / frontend-backend split --------------------------------
    slamThread: bool = False
    useFrontendSlam: bool = False
    backendProcessDelay: int = 0
    copySlamMapEveryNSlamFrames: int = 4
    deterministicSlamMapCopy: bool = True
    copyPartialMapToFrontend: bool = False

    # --- keyframe decision & adjacency -------------------------------------
    adjacentSpaceSize: int = 20
    keyframeDecisionMinIntervalSeconds: float = 0.1
    keyframeDecisionDistanceThreshold: float = 0.3
    keyframeDecisionCovisibilityRatio: float = 0.9
    keyframeCandidateInterval: int = 1
    delayIntervalMultiplier: int = 0

    # --- pose trail handling ------------------------------------------------
    useFullPoseTrail: bool = True
    useVariableLengthDeltas: bool = False
    useOdometryPoseTrailDelta: bool = False
    removeOdometryTransformZAxisTilt: bool = False
    cameraTrailLength: int = 20       # from odometry params (mapdb.cpp usage)

    # --- triangulation & map point gating ----------------------------------
    relativeReprojectionErrorThreshold: float = 0.005
    minTriangulationAngleTwoObs: float = 2.0
    minTriangulationAngleMultipleObs: float = 1.0
    minMapPointCullingAge: float = 3.0
    minObservationsForBA: int = 3
    keyframeCullMaxCriticalRatio: float = 0.3
    computeDenseStereoDepth: bool = False  # tracker param read by triangulation

    # --- bundle adjustment --------------------------------------------------
    nonKeyFramePoseAdjustment: bool = True
    applyLocalBundleAdjustment: bool = True
    # TPU-native extension (no reference equivalent): dispatch each local-BA
    # solve asynchronously and apply it (plus the post-BA pipeline tail) at a
    # fixed point early in the NEXT keyframe, hiding the device round trip
    # behind that frame's host matching work. Deterministic; matching runs on
    # map state that lags exactly one BA application — the same stale-snapshot
    # trade the reference makes for its frontend (mapper.cpp:281-343). See
    # docs/ARCHITECTURE.md §4.
    pipelinedLocalBA: bool = False
    localBAProblemSize: int = 20
    loopClosureLocalBAProblemSize: int = 50
    minVisibleMapPointsInCurrentFrameBA: int = 10
    minVisibleMapPointsInNeighborhoodBA: int = 20
    minKeyframesInBA: int = 3
    poseBAIterations: int = 10
    globalBAIterations: int = 10
    globalBAAfterLoop: bool = True
    odometryPriorStrengthPosition: float = 100.0
    odometryPriorStrengthRotation: float = 1000.0
    odometryPriorFixed: bool = True
    odometryPriorSimpleUncertainty: bool = False

    # --- place recognition (BoW-equivalent retrieval) -----------------------
    vocabularyPath: str = ""          # "" = in-tree trained codebook; else .npz
    # 65536 words: the trained hierarchical-k-means vocabulary, the port's
    # copy slam_tpu_torch/data/vocab_65536.npz; ops/bow.make_codebook raises
    # for a size without a trained file
    bowVocabularySize: int = 65536    # number of visual words in the codebook
    bowFeatureGroups: int = 128       # nodes for feature-bucketed matching
    bowMinInCommonRatio: float = 0.8
    bowScoreRatio: float = 0.75

    # --- loop closure -------------------------------------------------------
    requireTringulationForLoopClosures: bool = True  # [sic] reference spelling
    loopClosureFeatureMatchLoweRatio: float = 0.9
    minLoopClosureFeatureMatches: int = 20
    loopClosureRansacIterations: int = 200
    loopClosureRansacMinInliers: int = 20
    loopClosureRansacFixScale: bool = True
    loopClosureInlierThreshold: float = 10.0
    loopClosureRigidTransform: bool = False
    applyLoopClosures: bool = True
    epipolarCheckThresholdDegrees: float = 0.2
    minNeighbourCovisiblitities: int = 20  # [sic] reference spelling
    maximumDriftMetersPerSecond: float = 0.05
    maximumDriftRadiansPerSecond: float = 0.01
    maximumDriftMetersPerTraveled: float = 0.05
    maximumDriftRadiansPerTraveled: float = 0.01

    # --- persistence / outputs ----------------------------------------------
    mapdbLoadPath: List[str] = field(default_factory=list)
    mapdbSavePath: str = ""
    pointCloudSavePath: str = ""

    # --- stats / debug ------------------------------------------------------
    printBaStats: bool = False
    printLoopCloserStats: bool = False
    kfAsciiAdjacent: bool = False
    kfAsciiBA: bool = False
    kfAsciiWidth: int = 80


@dataclass
class Parameters:
    """Bundle mirroring ``odometry::Parameters`` as seen by the SLAM module."""
    slam: ParametersSlam = field(default_factory=ParametersSlam)
    # IMU-to-camera extrinsic used for trajectory export (mapper.cpp:527)
    imuToCamera: np.ndarray = field(default_factory=lambda: np.eye(4))


def calc_scale_factors(num_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level cumulative scale factors (reference: static_settings.cpp:9-15)."""
    s = np.ones(num_levels, dtype=np.float32)
    for level in range(1, num_levels):
        s[level] = scale_factor * s[level - 1]
    return s


ORB_PATCH_RADIUS = 19        # reference: static_settings.hpp:14


class StaticSettings:
    """Derived constants shared across the pipeline.

    Mirrors ``slam::StaticSettings`` (reference: static_settings.{hpp,cpp}).
    """

    def __init__(self, parameters: Optional[Parameters] = None):
        if parameters is None:
            parameters = Parameters()
        self.parameters = parameters
        p = parameters.slam
        self.scaleFactors = calc_scale_factors(p.orbScaleLevels, p.orbScaleFactor)

    def maxNumberOfKeypointsPerLevel(self) -> List[int]:
        """Geometric-series keypoint budget (reference: static_settings.cpp:39-60)."""
        p = self.parameters.slam
        counts = [0] * p.orbScaleLevels
        desired = (p.maxKeypoints * (1.0 - 1.0 / p.orbScaleFactor)
                   / (1.0 - (1.0 / p.orbScaleFactor) ** float(p.orbScaleLevels)))
        total = 0
        for level in range(p.orbScaleLevels - 1):
            counts[level] = int(round(desired))
            total += counts[level]
            desired *= 1.0 / p.orbScaleFactor
        counts[p.orbScaleLevels - 1] = max(int(p.maxKeypoints) - total, 0)
        return counts
