"""Typed configuration for the whole pipeline.

This package's own copy of texturefusion_tpu/config.py, the JAX
package's configuration dataclasses, field for field, so that this
package imports nothing of the JAX package. The parity tests hand either
package's config objects to both: the modules read fields by name.

Single source of truth replacing the reference's three config layers:
CLI positional args (ref: BasicAPI.cpp:1169-1205), the OpenCV YAML
``GlobalParameters`` (ref: BasicAPI.cpp:41-72, settings.yaml), the 13-field
``calib.txt`` (ref: BasicAPI.cpp:1108-1133), and the hard-coded chisel/MRF/atlas
constants (ref: MobileFusion.h:214-233, TexMap.h:54-55, Atlas.h:29-31).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics (ref: MultiViewGeometry.h:28-49 CameraPara,
    open_chisel/camera/PinholeCamera.h:33-63)."""

    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    depth_scale: float = 5000.0       # TUM depth PNG → meters divisor
    near_plane: float = 0.01          # ref: MobileFusion.h:228 nearPlaneDist
    far_plane: float = 3.0            # ref: MobileFusion.h:206 farPlaneDist default
    # radial/tangential distortion (calib.txt fields 8-12; usually 0 for TUM)
    d0: float = 0.0
    d1: float = 0.0
    d2: float = 0.0
    d3: float = 0.0
    d4: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """SLAM front-end knobs (ref: settings.yaml, GlobalParameters
    MultiViewGeometry.h:51-78)."""

    max_features: int = 1000          # settings.yaml max_feature_num
    max_features_pad: int = 1024      # static padded keypoint capacity
    pyramid_levels: int = 8           # ref: ORBextractor(…, 8 levels)
    pyramid_scale: float = 1.2
    fast_threshold: float = 20.0      # ref: iniThFAST=20
    descriptor_bits: int = 256
    hamming_threshold: int = 50       # settings.yaml hamming_distance_threshold
    ransac_iterations: int = 400      # settings.yaml ransac_maximum_iterations
    reproj_3d_threshold: float = 0.01  # settings.yaml reprojection_error_3d_threshold
    reproj_2d_threshold: float = 6.0   # settings.yaml reprojection_error_2d_threshold
    minimum_disparity: float = 0.1     # keyframe promotion disparity gate
    scale_change_ratio: float = 0.4    # ref: GCSLAM.cpp:315-327 keyframe decision
    max_tracking_failures: int = 3     # consecutive failures forcing keyframe
    max_candidates: int = 5            # settings.yaml maximum_keyframe_match_num
    salient_score_threshold: float = 1.5
    use_fine_search: bool = True
    max_matches_pad: int = 1024        # static padded correspondence capacity
    outlier_filter_rounds: int = 5     # ref: MultiViewGeometry.cpp:589-593
    gn_iterations: int = 6             # Huber GN refinement iterations
    huber_delta: float = 0.008         # Huber norm threshold for 3D residuals
    min_matches: int = 20              # minimum inliers to accept registration
    keyframe_min_distance: int = 4     # settings.yaml keyframe_minimum_distance
    blur_threshold: float = 3.0        # ref: BasicAPI.cpp:1256-1266 Laplacian gate
    use_icp: bool = False              # settings.yaml use_icp_registration
    icp_weight: float = 0.5            # settings.yaml icp_weight
    # deferred keyframe adoption: a steady-state promotion adopts the
    # keyframe at once and consumes its loop-closure probe, edges and BA a
    # frame later (the reference blocks its tracking thread on
    # update_keyframe, GCSLAM.cpp:52-185)
    defer_promote: bool = True
    # re-register a frame finalized against a superseded keyframe (the
    # pipelined tracker) against the adopted one, adopted when it lands
    refine_stale: bool = True


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """FastBA / pose-graph optimization (ref: MultiViewGeometry.cpp:915-1217)."""

    gn_rounds: int = 3                 # ref: optimizeKeyFrameMapRobust 3× GN
    gn_iterations_per_round: int = 4
    huber_delta: float = 0.008
    rollback_error_growth: float = 1.05  # rollback if error ↑ >5% (ref :1165-1205)
    levenberg_lambda: float = 1e-6       # diagonal damping for the dense solve
    # the initial keyframe and edge capacities: the pose array, the DBs
    # and the observation columns, and the edge store, double past them
    max_keyframes: int = 512
    max_edges: int = 4096
    # the Schur-complement solve (eliminate interior keyframes, solve the
    # separator system; parallel/ba.py schur_gn) from this many keyframes
    # on. On one device the port's GCSLAM takes the equal dense solve at
    # any keyframe count; over a DeviceMesh BA is edge-sharded, Schur from
    # here on, distributed GN below.
    schur_min_keyframes: int = 64
    schur_separator_budget: int = 128
    # the floors of BA's keyframe and edge buckets (fixed shapes, as the
    # JAX package's compiled programs have): on one device the port runs
    # BA at the bucketed counts, so that its captured rounds are replayed.
    kf_bucket_floor: int = 32
    edge_bucket_floor: int = 128


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Chunked TSDF volume (ref: MobileFusion.h:214-233, open_chisel)."""

    voxel_resolution: float = 0.02     # meters (CLI arg, 0.005-0.04 range)
    chunk_size: int = 8                # 8³ voxels per chunk
    capacity: int = 8192               # chunk slot pool size (static)
    # Quadratic truncator coefficients: trunc(z) = scale*(q*z² + l*z + c)
    # ref: MobileFusion.h:215-218
    truncation_quad: float = 0.0019
    truncation_linear: float = 0.00152
    truncation_const: float = 0.001504
    truncation_scale: float = 6.0
    integration_weight: float = 1.0    # ConstantWeighter(1)
    # NOTE: the reference declares carving knobs (MobileFusion.h:219-220
    # useCarving/carvingDist) but its production AVX integration path
    # never reads them; parity here is BY OMISSION — no carving knobs
    # exist rather than knobs that silently do nothing.
    min_weight: float = 0.5            # weight below which voxel resets
    color_band_pad: float = 0.01       # color update band ±(res·√3/2 + 0.01)
    color_saturation: float = 120.0    # accumulator rescale threshold (÷4)
    max_update_chunks: int = 2048      # static per-frame intersect-chunk budget
    # the port's voxel update is the hand-written CUDA kernel K2
    # (csrc/tsdf_integrate.cu) on the card, and the plain version in
    # ops/tsdf.py on the CPU; max_update_chunks bounds its listed chunks
    local_frames_per_keyframe: int = 6  # depth-only local frames integrated
    # chunk streaming (fusion/streaming.py): offload far chunks to host
    # when more than this many slots are resident; 0 disables
    max_resident_chunks: int = 0
    streaming_radius: float = 6.0      # meters: chunks beyond this offload
    # keyframe-state device budget: stage old keyframes' local depths /
    # quality / weights out to host once their estimated device footprint
    # exceeds this many MB (ref: clearRedudentFrameMemory
    # MobileFusion.cpp:71-90).
    keyframe_device_budget_mb: float = 2048.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Incremental marching cubes (ref: ChunkManager.cpp:595-1004)."""

    max_mesh_chunks: int = 2048        # static per-cycle remesh budget
    vertex_budget: int = 30_000_000    # ref: MobileFusion.h:32-33
    # device-resident mesh pool: per-chunk capacities (meshes live on
    # device between cycles; host fetches only at export). Overflowing
    # chunks clamp with a warning (8³ chunks rarely exceed ~120 verts)
    pool_verts_per_chunk: int = 256
    pool_tris_per_chunk: int = 384


@dataclasses.dataclass(frozen=True)
class TextureConfig:
    """View-selection MRF + atlas + color compensation
    (ref: TexMap.{h,cpp}, Atlas.{h,cpp}, Chisel.cpp:149-286)."""

    mrf_potts_weight: float = 1.0      # ref: TexMap PairwisePotts(1.0)
    # per-cycle cap on uv refreshes of merely-remeshed chunks (label
    # changes and new chunks always process); keeps texture cost flat as
    # the map grows (ref: TexMap.cpp:257-406 incremental view selection)
    patch_refresh_budget: int = 768
    # per-cycle projection budget M of the texture cycle (changed chunks
    # beyond it carry over to the next cycle). It also sizes the cycle's
    # host read, M × pool_verts_per_chunk × (2 int32 uv + 1 bool)
    patch_project_budget: int = 384
    mrf_edge_weight: float = 0.5       # ref: TexMap.h:54-55
    mrf_sweeps: int = 12               # ICM sweeps (replaces mapmap tree solves)
    # the JAX package pads the MRF's nodes to a bucket of at least this
    # many (fixed compiled shapes); the port reads and ignores it and
    # solves at the true node count
    problem_bucket_floor: int = 2048
    # the keyframe image stack's first capacity in rows, each H × W × 8
    # bytes of device memory (int32 packed rgb, float32 depth); it doubles
    # when a keyframe slot outgrows it
    kf_stack_initial: int = 64
    max_labels: int = 16               # per-chunk candidate keyframe labels
    atlas_size: int = 13824            # ref: Atlas.h:29-30
    patch_scale: float = 4800.0        # PATCH_WIDTH = floor(4800·res) (Atlas.h:62-65)
    wrong_mapping_color: float = 0.6   # ref: Patch.cpp:88-96
    wrong_mapping_depth: float = 0.7
    wrong_mapping_frac: float = 0.3


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh scale-out (new capability; see SURVEY.md §2.3)."""

    data_axis: str = "chunks"          # TSDF chunk slots sharded over this axis
    edge_axis: str = "edges"           # BA edges sharded over this axis
    n_devices: Optional[int] = None    # None = use all available
    # run fusion cycles on a worker thread so keyframe-rate fusion work
    # overlaps frame-rate tracking — the reference's two-thread pipeline
    # (ref: MobileFusion.cpp:92-112 MapManagement ∥ tracking)
    async_fusion: bool = False
    # software-pipelined tracking: a frame's decisions are finalized
    # pipeline_depth frames after its device step was dispatched, later
    # while its stats have not landed (up to pipeline_max_ride frames in
    # flight, at least depth + 1)
    pipelined_tracking: bool = True
    # shard the TSDF chunk-slot axis (and the mesh pool) over the devices
    # (SURVEY.md §2.3 "chunk batch is the natural shard axis"), slot s on
    # shard s % n; sharded when more than one device of the pipeline's type
    # exists (the CPU counts parallel/mesh.CPU_SHARDS virtual devices)
    tsdf_sharded: bool = False
    pipeline_depth: int = 2
    pipeline_max_ride: int = 0
    # deferred cycle results: a fusion cycle only dispatches its remesh,
    # texture cycle and GC probe and starts their copies, and consumes the
    # previous cycles' results (mesh counts, texture outputs, GC probe,
    # observation qualities, deferred integrations) at its start, once
    # they have landed; texture labels and GC then lag a keyframe and
    # finish() catches up. Off: each cycle reads its own results. The
    # discovery prefetch runs either way (fusion/pipeline.py)
    async_cycle_results: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    tsdf: TSDFConfig = dataclasses.field(default_factory=TSDFConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    texture: TextureConfig = dataclasses.field(default_factory=TextureConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config() -> PipelineConfig:
    """Small capacities for fast unit tests on CPU."""
    return PipelineConfig(
        camera=CameraConfig(width=160, height=120, fx=120.0, fy=120.0,
                            cx=79.5, cy=59.5, far_plane=6.0),
        tracking=TrackingConfig(max_features=256, max_features_pad=256,
                                max_matches_pad=256, ransac_iterations=128,
                                # 160×120 frames yield ~4× fewer matches
                                # than VGA; scale the acceptance gate
                                min_matches=12),
        ba=BAConfig(max_keyframes=32, max_edges=128),
        tsdf=TSDFConfig(voxel_resolution=0.05, capacity=1024,
                        max_update_chunks=512),
        mesh=MeshConfig(max_mesh_chunks=512),
        texture=TextureConfig(atlas_size=2048),
    )
