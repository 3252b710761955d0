"""Typed configuration for the SLAM engine (PyTorch port; field-for-field
the same as the JAX package's config).

The reference reads a single OpenCV-YAML file per run (reference:
src/Tracking.cc:46-149 parses Camera.*, ORBextractor.*, ThDepth,
DepthMapFactor) and hard-codes every other threshold as C++ constants
(e.g. ORBmatcher.cc:37-39 TH_HIGH/TH_LOW, Optimizer.cc:85-86 chi2 gates,
KeyFrame.cc:330 covisibility weight, LocalMapping.cc:190-201 culling rules).

Here every constant is a named config field with the reference default, and
``load_yaml`` accepts the reference's YAML key names so the reference's
per-dataset config files (Examples/*/*.yaml) work unmodified.

Extra fields with no reference analog configure the fixed-shape capacities
that a static-shape XLA program needs (max keypoints, max observations, ...).
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Optional


class Sensor:
    """Sensor types (reference: include/System.h eSensor)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + radial-tangential distortion + stereo baseline.

    Mirrors the Camera.* YAML keys (reference: src/Tracking.cc:53-147).
    """

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    # Distortion (OpenCV order): k1, k2, p1, p2, k3.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    # Stereo: baseline times fx ("Camera.bf" in the reference YAMLs).
    bf: float = 0.0
    # Images are RGB (1) or BGR (0) — only matters for color input.
    rgb: int = 1

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (reference: ORBextractor.* YAML keys and
    src/ORBextractor.cc constants)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20  # initial FAST threshold (ORBextractor.iniThFAST)
    min_th_fast: int = 7  # fallback threshold (ORBextractor.minThFAST)
    # Border kept free of features (reference: ORBextractor.cc:74
    # EDGE_THRESHOLD=19).
    edge_threshold: int = 19
    # Spatial-balancing cell size in pixels at each level (reference uses a
    # 30px FAST grid + quadtree, ORBextractor.cc:765; we use per-cell top-k).
    cell_size: int = 30
    # Orientation patch half-size (reference: HALF_PATCH_SIZE=15).
    half_patch: int = 15
    # Descriptor patch size for the BRIEF pattern.
    patch_size: int = 31

    def scale_factors(self) -> list[float]:
        return [self.scale_factor**i for i in range(self.n_levels)]

    def level_sigma2(self) -> list[float]:
        return [s * s for s in self.scale_factors()]

    def features_per_level(self) -> list[int]:
        """Geometric feature budget per level (reference:
        ORBextractor.cc:435-446)."""
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1.0 - factor) / (
            1.0 - factor**self.n_levels
        )
        per = []
        total = 0
        for _ in range(self.n_levels - 1):
            n = int(round(n_desired))
            per.append(n)
            total += n
            n_desired *= factor
        per.append(max(self.n_features - total, 0))
        return per


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor-matching thresholds (reference: src/ORBmatcher.cc:37-39)."""

    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30  # rotation-consistency histogram bins
    nn_ratio_tracking: float = 0.9
    nn_ratio_mapping: float = 0.6


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking state-machine thresholds (reference: src/Tracking.cc)."""

    # Stereo/RGBD: points closer than th_depth * baseline are "close"
    # (reference: Tracking.cc ThDepth).
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    # Min inliers after motion-model / reference-KF pose opt
    # (reference: Tracking.cc:798,919).
    min_inliers_pose: int = 10
    # TrackLocalMap acceptance: 50 normally, 30 right after reloc
    # (reference: Tracking.cc:967-971).
    min_inliers_local_map: int = 30
    min_inliers_local_map_strict: int = 50
    # Local map keyframe cap (reference: Tracking.cc:1285).
    max_local_keyframes: int = 80
    # Relocalization acceptance (reference: Tracking.cc:1483).
    min_inliers_reloc: int = 50
    # Max frames between keyframes = fps; min = 0 (reference:
    # Tracking.cc:989-990).
    max_frames_between_kf: int = 30
    min_frames_between_kf: int = 0
    # Rotation part of the constant-velocity prediction, in [0, 1].
    # 0 (default) = translation-only prediction. The reference extrapolates
    # full rotation (Tracking.cc:875); observed failure mode here: an
    # extrapolated rotation error re-centers the projection search window
    # onto aliased texture, the matcher locks in, and the error compounds
    # ~1.5x per frame until loss. Damping to 0 held rotation error flat.
    velocity_rotation_fraction: float = 0.0
    # Monocular init: min matches to attempt (reference: Tracking.cc:589,605).
    min_init_matches: int = 100
    # Stereo init: min close points (reference: Tracking.cc:511).
    min_stereo_init_points: int = 500
    # Stereo keyframe: create up to this many closest new points
    # (reference: Tracking.cc:1123).
    max_new_stereo_points: int = 100
    # Ignored by the port; kept so both packages read the same
    # configurations. In the JAX package it bounds the frames in flight
    # (0 = auto: 3 on an accelerator, 1 on the CPU), to hide a remote
    # chip's readback latency. The port applies every in-flight frame at
    # the next track() on every device, waiting for its readback (the
    # device is done when the host ends its enqueue), so no depth binds.
    pipeline_depth: int = 0


@dataclass(frozen=True)
class MappingConfig:
    """Local-mapping thresholds (reference: src/LocalMapping.cc)."""

    # MapPoint culling (reference: LocalMapping.cc:190-201).
    min_found_ratio: float = 0.25
    # Keyframe culling redundancy (reference: LocalMapping.cc:693).
    kf_cull_redundancy: float = 0.9
    kf_cull_min_obs: int = 3
    # Covisibility edge threshold (reference: KeyFrame.cc:330-346).
    covisibility_weight: int = 15
    # Neighbors searched for triangulation: 20 mono / 10 stereo
    # (reference: LocalMapping.cc:211-214).
    triangulation_neighbors_mono: int = 20
    triangulation_neighbors_stereo: int = 10


@dataclass(frozen=True)
class OptimizerConfig:
    """Gauss-Newton/LM budgets and gates (reference: src/Optimizer.cc)."""

    # chi2 inlier gates at 95%: 2-dof mono, 3-dof stereo
    # (reference: Optimizer.cc:85-86,369-370).
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    # Pose optimization: 4 rounds x 10 iterations (reference:
    # Optimizer.cc:371).
    pose_opt_rounds: int = 4
    pose_opt_its: int = 10
    # Local BA: 5 + 10 iterations (reference: Optimizer.cc:660,707).
    local_ba_its_first: int = 5
    local_ba_its_second: int = 10
    # Global BA iterations (reference: LoopClosing.cc:650, Tracking.cc:686).
    global_ba_its: int = 10
    init_ba_its: int = 20
    # Essential graph (reference: Optimizer.cc:987).
    essential_graph_its: int = 20
    # Essential-graph covisibility edge weight (reference: Optimizer.cc:806).
    essential_graph_min_weight: int = 100
    # Sim3 optimization (reference: Optimizer.cc:1046-1241).
    sim3_its: int = 5
    sim3_chi2: float = 10.0
    # Implicit-Schur PCG settings (no reference analog; replaces g2o's
    # sparse Cholesky, Thirdparty/g2o/g2o/core/block_solver.hpp:354-447).
    pcg_iters: int = 50
    pcg_tol: float = 1e-6
    # LM damping init/scale.
    lm_lambda_init: float = 1e-4


@dataclass(frozen=True)
class LoopConfig:
    """Loop-closing thresholds (reference: src/LoopClosing.cc)."""

    # Consecutive-consistency threshold (reference: LoopClosing.cc:52 th=3).
    covisibility_consistency_th: int = 3
    # Dead time after a loop / map start (reference: LoopClosing.cc:114).
    min_kf_gap: int = 10
    # BoW match minimum to try Sim3 (reference: LoopClosing.cc:265-275).
    min_bow_matches: int = 20
    # Sim3 inliers to accept (reference: LoopClosing.cc:326-329).
    min_sim3_inliers: int = 20
    # Total matches after projection widening (reference: LoopClosing.cc:385).
    min_total_matches: int = 40
    # RANSAC settings (reference: LoopClosing.cc:283 SetRansacParameters).
    sim3_ransac_iters: int = 300
    sim3_min_inlier_frac: float = 0.0
    # Temporal dead-band for loop CANDIDATES (no reference analog): a
    # candidate must be at least this many keyframe serials older than
    # the query. The reference relies on covisibility alone to exclude
    # recent keyframes (its inverted file skips connected KFs,
    # KeyFrameDatabase.cc:93-96); with the sparser covisibility graph
    # here, recent-but-unconnected keyframes score high on BoW (adjacent
    # sectors look alike) and pollute the consistency chains.
    candidate_kf_gap: int = 20


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed-shape capacities for the static-shape array program.

    No reference analog: the reference grows std::vectors/maps dynamically;
    XLA needs compile-time shapes (SURVEY.md §7.3). All kernels mask on the
    live count.
    """

    max_keypoints: int = 2048  # per frame, post-selection
    max_keyframes: int = 1024
    max_points: int = 65536
    max_obs_per_point: int = 24
    max_matches: int = 2048
    # RANSAC hypothesis batch sizes (reference iterates sequentially:
    # Initializer.cc:78 200 iters; we evaluate all at once).
    ransac_init_iters: int = 256
    ransac_pnp_iters: int = 512
    ransac_sim3_iters: int = 256
    # Local-BA problem capacities (static shapes for the jitted solver).
    local_ba_max_kfs: int = 32
    local_ba_max_points: int = 8192
    local_ba_max_obs: int = 16384
    # Local tracked map capacity (reference caps local KFs at 80,
    # Tracking.cc:1285; points capped here for static shapes).
    local_map_max_points: int = 8192
    # Fuse stage: fixed (src,dst) pair capacity (static shape — a growing
    # bucket recompiled the fuse kernel mid-run).
    fuse_max_pairs: int = 32


@dataclass(frozen=True)
class VocabularyConfig:
    """BoW vocabulary shape (reference: Thirdparty/DBoW2, ORBvoc is k=10
    L=6; see TemplatedVocabulary.h)."""

    branching: int = 10
    depth: int = 4  # small default; ORBvoc uses 6
    # Feature-vector grouping level from the top (reference levelsup=4,
    # Frame.cc:400).
    levels_up: int = 2
    seed: int = 42
    # Vocabulary source: None (default) loads the shipped pretrained
    # artifact (the JAX package's assets/vocab_k10_L5.npz, the analog of the
    # reference's ORBvoc.txt); a path loads that file (.npz from
    # bow.vocab.save, or DBoW2 .txt via bow.vocab.load_dbow2_text);
    # "online" trains from the first keyframes of the run.
    path: Optional[str] = None
    train_keyframes: int = 4


@dataclass(frozen=True)
class SlamConfig:
    sensor: int = Sensor.MONOCULAR
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    vocabulary: VocabularyConfig = field(default_factory=VocabularyConfig)

    def replace(self, **kwargs) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# OpenCV-YAML loader (reference config files are "%YAML:1.0" FileStorage
# documents, not strict YAML — parse the flat key: value lines directly).
# ---------------------------------------------------------------------------

_YAML_KEY_RE = re.compile(r"^([A-Za-z0-9_.]+)\s*:\s*(.*?)\s*$")


def _parse_opencv_yaml(text: str) -> dict:
    """Flat `key: value` pairs plus `!!opencv-matrix` blocks (rows/cols/
    data), which the EuRoC stereo YAML uses for the LEFT.*/RIGHT.*
    rectification matrices (reference: Examples/Stereo/EuRoC.yaml:37-80,
    consumed by stereo_euroc.cc:72-87). Matrix values are returned as
    nested lists (rows x cols)."""
    out: dict = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        i += 1
        if not line or line.lstrip().startswith("%"):
            continue
        m = _YAML_KEY_RE.match(line)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if "opencv-matrix" in val or (val == "" and i < len(lines)):
            # Gather the indented block: rows / cols / dt / data.
            rows = cols = None
            data: list[float] = []
            while i < len(lines):
                sub = lines[i].split("#", 1)[0]
                if not sub.strip():
                    i += 1
                    continue
                if not sub.startswith((" ", "\t")):
                    break
                s = sub.strip()
                if s.startswith("rows:"):
                    rows = int(s.split(":", 1)[1])
                elif s.startswith("cols:"):
                    cols = int(s.split(":", 1)[1])
                elif s.startswith("data:") or data or s.startswith("["):
                    chunk = s.split(":", 1)[1] if s.startswith("data:") else s
                    for tok in chunk.replace("[", " ").replace("]", " ").replace(
                        ",", " "
                    ).split():
                        data.append(float(tok))
                i += 1
            if rows and cols and len(data) == rows * cols:
                out[key] = [
                    data[r * cols : (r + 1) * cols] for r in range(rows)
                ]
            continue
        if val == "":
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip("\"'")
    return out


def load_yaml_raw(path: str) -> dict:
    """All key/value pairs of a reference-format settings YAML, including
    opencv-matrix blocks (e.g. the EuRoC LEFT.*/RIGHT.* entries)."""
    with open(path) as f:
        return _parse_opencv_yaml(f.read())


def load_yaml(path: str, sensor: int = Sensor.MONOCULAR) -> SlamConfig:
    """Load a reference-format settings YAML (e.g. Examples/Monocular/
    TUM1.yaml key names; reference parser src/Tracking.cc:46-149)."""
    with open(path) as f:
        kv = _parse_opencv_yaml(f.read())

    def g(key, default):
        return kv.get(key, default)

    cam = CameraConfig(
        fx=float(g("Camera.fx", 500.0)),
        fy=float(g("Camera.fy", 500.0)),
        cx=float(g("Camera.cx", 320.0)),
        cy=float(g("Camera.cy", 240.0)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        fps=float(g("Camera.fps", 30.0)),
        bf=float(g("Camera.bf", 0.0)),
        rgb=int(g("Camera.RGB", 1)),
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    fps = cam.fps if cam.fps > 0 else 30.0
    tracking = TrackingConfig(
        th_depth=float(g("ThDepth", 35.0)),
        depth_map_factor=float(g("DepthMapFactor", 1.0)),
        max_frames_between_kf=int(round(fps)),
        # Extension key (no reference analog — its 500-point gate is a
        # compile-time constant, Tracking.cc:511): lets low-texture
        # sequences lower the stereo/RGBD init gate from YAML.
        min_stereo_init_points=int(g("Tracking.minStereoInitPoints", 500)),
        velocity_rotation_fraction=float(
            g("Tracking.velocityRotationFraction", 0.0)
        ),
    )
    return SlamConfig(sensor=sensor, camera=cam, orb=orb, tracking=tracking)
