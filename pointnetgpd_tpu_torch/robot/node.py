"""Online grasp-detection frame: the kinect2grasp loop, on the card.

Port of ``pointnetgpd_tpu/robot/node.py`` (reference
dex-net/apps/kinect2grasp.py:110-556): voxel downsample -> size bucket ->
normals (whole cloud, or lazily in the GPG seed windows) -> GPG candidates
-> on-device compaction to ``num_grasps`` -> crop + PointNet + vote + rank.
``GraspDetector.process_frame`` is pure (no ROS). The size-bucket,
``upload_dtype`` and adaptive-bucket logic are kept because results depend
on them. Neighbor selection is always exact in the port, so the JAX
config's ``sampler_exact`` switch is accepted and read by nothing. The
stages carry
``torch.profiler.record_function`` labels (``frame.upload_voxel``,
``frame.normals``, ``frame.gpg``, ``frame.score``, ``frame.collect``),
which cost nothing
while no profiler runs.

``GraspDetector.warmup`` runs one synthetic frame per size bucket before a
node goes live: on the card nothing is compiled per shape, but the first
pass at each bucket pays the kernel library's build, the cuBLAS and cuDNN
handles and the caching allocator's first allocations. ``run_ros_node``
wires the detector to the reference's topics; ROS is imported only inside
it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from ..draws import Draws
from ..grasping.gripper import Gripper
from ..grasping.samplers import gpg_sample_candidates
from ..inference.scorer import GraspScorer
from ..ops.cloud import (estimate_normals_knn, estimate_normals_knn_window,
                         voxel_downsample_packed)


def remove_table_points(points: np.ndarray, z_thresh: float = 0.005,
                        table_z: float = 0.0) -> np.ndarray:
    """Drop points within z_thresh of the table plane z = table_z."""
    return points[points[:, 2] > table_z + z_thresh]


def remove_grasp_outside_tray(frames: np.ndarray, tray_x=(-0.2, 0.2),
                              tray_y=(-0.2, 0.2)) -> np.ndarray:
    """Keep the grasps whose bottom centers lie inside the tray rectangle
    (kinect2grasp.py:370-388)."""
    frames = np.asarray(frames)
    bc = frames[:, 0]
    ok = ((bc[:, 0] > tray_x[0]) & (bc[:, 0] < tray_x[1])
          & (bc[:, 1] > tray_y[0]) & (bc[:, 1] < tray_y[1]))
    return frames[ok]


@dataclass
class DetectorConfig:
    """Online-path parameters (kinect2grasp.py:42-63,429 + sampler params);
    see the JAX package's ``DetectorConfig`` for each field's rationale."""

    num_grasps: int = 40
    max_num_samples: int = 150
    n_voxel: int = 500
    normal_k: int = 30
    input_points_num: int = 500
    minimal_points_send_to_point_net: int = 20
    repeat: int = 1
    select_point_above_table: float = 0.010
    cloud_pad_to: int = 8192
    raw_pad_to: int | None = None
    normal_window: int = 2048
    lazy_normals: bool = True
    adaptive_bucket: bool = False
    adaptive_margin: float = 1.25
    upload_dtype: str = "float16"
    # the JAX package's exact seed-window selection switch; a no-op here:
    # the port selects neighbors exactly everywhere, as JAX does on every
    # backend but the TPU (JAX ops/cloud.py min_k)
    sampler_exact: bool = False
    crop_mode: str = "reference"
    seed_bias: str = "none"

    @classmethod
    def reference_parity(cls, **overrides) -> "DetectorConfig":
        """The reference-shaped flow: whole-cloud exact KNN normals, fp32
        upload, raw-count size buckets, reference crop box."""
        cfg = dict(lazy_normals=False, upload_dtype="float32",
                   normal_window=0, adaptive_bucket=False,
                   sampler_exact=True, seed_bias="none",
                   crop_mode="reference")
        cfg.update(overrides)
        return cls(**cfg)

    @classmethod
    def production(cls, **overrides) -> "DetectorConfig":
        """Lazy seed-window normals, fp16 upload, Morton-window KNN,
        adaptive buckets, training-frame crops."""
        cfg = dict(lazy_normals=True, upload_dtype="float16",
                   normal_window=2048, adaptive_bucket=True,
                   sampler_exact=False, seed_bias="none",
                   crop_mode="dataset")
        cfg.update(overrides)
        return cls(**cfg)


class GraspDetector:
    """Scene cloud -> ranked good grasps. Runs on the scorer's device.

    With a scorer built on a mesh (``GraspScorer(mesh=...)``, JAX
    ``:160-178``) the whole frame composes over it: the window normals split
    their query chunks, the GPG sampler its frames and the scorer its
    candidates, each against the cloud on every shard's device (no
    collectives); results equal the single-device frame up to the window
    normals' mesh-dependent tail (``ops/cloud.py``). A GPD scorer has no
    mesh."""

    def __init__(self, scorer: GraspScorer, gripper: Gripper = Gripper(),
                 config: DetectorConfig | None = None):
        self.scorer = scorer
        self.gripper = gripper
        self.cfg = config or DetectorConfig()
        self.device = scorer.device
        self.mesh = getattr(scorer, "mesh", None)
        self.scorer.num_points = self.cfg.input_points_num
        self.scorer.repeat = self.cfg.repeat
        self.scorer.min_points = self.cfg.minimal_points_send_to_point_net
        self.scorer.crop_recenter = self.cfg.crop_mode == "dataset"
        self._last_voxel_count: int | None = None   # adaptive_bucket state

    def warmup(self, max_points: int, cam_pos=(1.0, 1.0, 1.0)):
        """Run one synthetic frame at every cloud size bucket up to
        ``max_points`` raw points, so that no live frame pays a bucket's
        first pass; returns the bucket sizes. The blob's points spread over
        0.4 m survive the voxel downsample about one to one, so a
        (b - cloud_pad_to / 2)-point cloud lands in bucket b; the bucket is
        pinned to b even where an adaptive bucket would shrink it."""
        rng = np.random.RandomState(0)
        pad = self.cfg.cloud_pad_to
        buckets = list(range(pad, max_points + pad, pad))
        for b in buckets:
            pts = (rng.rand(b - pad // 2, 3) * 0.4 - 0.2).astype(np.float32)
            pts[:, 2] = np.abs(pts[:, 2]) + 0.02
            self.collect_frame(self.dispatch_frame(
                pts, np.asarray(cam_pos, np.float32), _force_bound=True))
        # the blob's voxel count is no prior for a live frame
        self._last_voxel_count = None
        return buckets

    def process_frame(self, points: np.ndarray, cam_pos: np.ndarray,
                      seed: int = 0, funnel: bool = False, draws=None):
        """One frame -> dict with the ranked good grasps as (5, 3) frames
        [bottom_center, approach, binormal, minor, bottom_center_modified],
        their scores, every candidate's prediction, the downsampled cloud
        (a device tensor) and ``n_valid``. ``funnel=True`` adds the
        per-guard rejection table. ``draws`` replaces the frame's random
        numbers (default: ``Draws(seed)`` for the sampler and
        ``Draws(seed + 1)`` for the scorer)."""
        return self.collect_frame(self.dispatch_frame(
            points, cam_pos, seed, funnel=funnel, draws=draws))

    def dispatch_frame(self, points: np.ndarray, cam_pos: np.ndarray,
                       seed: int = 0, _force_bound: bool = False,
                       funnel: bool = False, draws=None):
        """Enqueue the frame on the device; pair with ``collect_frame``."""
        cfg = self.cfg
        dev = self.device
        points = np.asarray(points, np.float32)
        points_orig = points
        # pad the RAW cloud to a bucket by repeating the first point (same
        # voxel -> downsample unchanged)
        raw_pad = cfg.raw_pad_to or cfg.cloud_pad_to
        n_raw = len(points)
        if n_raw > 0:
            raw_bucket = -(-n_raw // raw_pad) * raw_pad
            if raw_bucket > n_raw:
                points = np.concatenate(
                    [points, np.repeat(points[:1], raw_bucket - n_raw, 0)])
        with record_function("frame.upload_voxel"):
            if cfg.upload_dtype == "float16":
                pts_up = torch.from_numpy(points.astype(np.float16)).to(dev) \
                    .to(torch.float32)
            else:
                pts_up = torch.from_numpy(points).to(dev)
            packed, count = voxel_downsample_packed(pts_up,
                                                    n_grid=cfg.n_voxel)

        # size bucket from the RAW count (an upper bound on the voxel
        # count); the sentinel tail is never a seed, neighbor or crop point
        bound_bucket = max(-(-max(n_raw, 1) // cfg.cloud_pad_to), 1) \
            * cfg.cloud_pad_to
        bucket = bound_bucket
        if (cfg.adaptive_bucket and not _force_bound
                and self._last_voxel_count is not None):
            est = int(self._last_voxel_count * cfg.adaptive_margin) + 1
            est_bucket = max(-(-est // cfg.cloud_pad_to), 1) \
                * cfg.cloud_pad_to
            bucket = min(bound_bucket, est_bucket)
        if bucket <= packed.shape[0]:
            pts_dev = packed[:bucket]
        else:
            pts_dev = torch.cat([packed, torch.full(
                (bucket - packed.shape[0], 3), -1e6, device=dev)])

        # camera-consistent normals over the REAL cloud's bbox
        cam = torch.as_tensor(np.asarray(cam_pos, np.float32), device=dev)
        finite = pts_dev[:, 0] > -9.9e5
        lo = torch.where(finite[:, None], pts_dev, 1e9).amin(dim=0)
        hi = torch.where(finite[:, None], pts_dev, -1e9).amax(dim=0)
        ok = finite.any()
        lo = torch.where(ok, lo, 0.0)
        hi = torch.where(ok, hi, 1.0)
        with record_function("frame.normals"):
            if cfg.lazy_normals and cfg.normal_window:
                normals = None
            elif cfg.normal_window and pts_dev.shape[0] > cfg.normal_window:
                normals = estimate_normals_knn_window(
                    pts_dev, cam, k=cfg.normal_k, window=cfg.normal_window,
                    bbox=(lo, hi), mesh=self.mesh)
            else:
                normals = estimate_normals_knn(pts_dev, cam, k=cfg.normal_k)

        with record_function("frame.gpg"):
            cand = gpg_sample_candidates(
                pts_dev, normals, self.gripper,
                num_seeds=cfg.max_num_samples,
                min_points_above_table=cfg.select_point_above_table,
                camera_pos=cam, bbox=(lo, hi), normal_k=cfg.normal_k,
                normal_window=cfg.normal_window, seed_bias=cfg.seed_bias,
                debug=funnel, draws=draws or Draws(seed, dev),
                mesh=self.mesh)
        if funnel:
            cand, funnel_dev = cand
        # compact valid candidates on the device (stable: original order)
        # into a fixed num_grasps buffer with a validity mask
        n_valid_dev = cand.valid.sum()
        order0 = torch.argsort((~cand.valid).to(torch.int8), stable=True)
        frames = cand.frames[order0[:cfg.num_grasps]]
        frame_valid = torch.arange(cfg.num_grasps, device=dev) < n_valid_dev

        extra = (frames, n_valid_dev, count)
        if funnel:
            extra = extra + (funnel_dev,)
        with record_function("frame.score"):
            pending = self.scorer.dispatch_candidates(
                pts_dev, frames, hand_depth=self.gripper.hand_depth,
                width=self.gripper.open_width, seed=seed + 1,
                valid=frame_valid, extra_fetch=extra, draws=draws)
        return pending, pts_dev, bucket, points_orig, cam_pos, seed, draws

    def collect_frame(self, dispatched):
        """Copy the frame's result to the host and postprocess. An adaptive
        bucket that overflowed (voxel count > bucket) is redone at the
        raw-bound bucket."""
        cfg = self.cfg
        pending, pts_dev, bucket, raw_pts, cam_pos, seed, draws = dispatched
        with record_function("frame.collect"):
            result, extras = self.scorer.collect(pending)
        frames_np, n_valid, n_real = extras[:3]
        funnel = ({k: (int(v) if np.ndim(v) == 0 else np.asarray(v))
                   for k, v in extras[3].items()}
                  if len(extras) > 3 else None)
        n_real = int(n_real)
        self._last_voxel_count = n_real
        if n_real > bucket:
            redo = self.dispatch_frame(raw_pts, cam_pos, seed=seed,
                                       _force_bound=True,
                                       funnel=funnel is not None,
                                       draws=draws)
            return self.collect_frame(redo)
        keep = min(cfg.num_grasps, int(n_valid))
        frames_np = frames_np[:keep]
        order = result["good_indices"]
        order = order[order < keep]
        out = {
            "grasps": frames_np[order],
            "scores": result["score"][order],
            "pred": result["pred"][:keep],
            "all_frames": frames_np,
            "all_scores": result["score"][:keep],
            "counts": result["counts"][:keep],
            "points": pts_dev[:n_real],
            "n_valid": int(n_valid),
        }
        if funnel is not None:
            out["funnel"] = funnel
        return out

    def process_frames(self, frames_iter, cam_pos, start_seed: int = 0):
        """Frame stream with one frame in flight: frame N+1 is dispatched
        before frame N is collected."""
        pending = None
        for i, points in enumerate(frames_iter):
            nxt = self.dispatch_frame(points, np.asarray(cam_pos, np.float32),
                                      seed=start_seed + i)
            if pending is not None:
                yield self.collect_frame(pending)
            pending = nxt
        if pending is not None:
            yield self.collect_frame(pending)


def run_ros_node(detector: GraspDetector, cam_pos, *,
                 cloud_topic: str = "/table_top_points",
                 marker_topic: str = "gripper_vis",
                 grasp_topic: str = "/detect_grasps/clustered_grasps",
                 rate_hz: float = 10.0, publish_all: bool = False,
                 max_frames: int | None = None, pipeline: bool = False):
    """The reference node's loop (kinect2grasp.py:400-424 setup, :412-418
    ``/robot_at_home`` gating, :516-553 output): markers for every ranked
    good grasp, then the best grasp as a one-element GraspConfigList
    (``publish_all=True`` publishes the whole ranked list). Needs rospy,
    sensor_msgs, visualization_msgs and gpd_grasp_msgs. ``max_frames``
    bounds the frames taken (None: until shutdown).

    ``pipeline=True`` keeps one frame in flight (frame N+1 is dispatched
    before frame N is collected and published); a frame in flight when the
    robot leaves home is collected and dropped, since the scene it saw is
    gone."""
    import rospy
    from gpd_grasp_msgs.msg import GraspConfigList
    from sensor_msgs.msg import PointCloud2
    from visualization_msgs.msg import MarkerArray

    from .pointclouds import pointcloud2_to_xyz_array
    from .ros_messages import grasp_config_list_msg, gripper_marker_array

    rospy.init_node("grasp_tf_broadcaster", anonymous=True)
    pub_markers = rospy.Publisher(marker_topic, MarkerArray, queue_size=1)
    pub_grasps = rospy.Publisher(grasp_topic, GraspConfigList, queue_size=1)
    rate = rospy.Rate(rate_hz)
    # the simulation default of the reference (:404); robot_state.py's
    # publisher overwrites it on a real robot
    rospy.set_param("/robot_at_home", "true")

    def publish(out):
        if len(out["grasps"]) == 0:
            rospy.loginfo("No good grasps this frame.")
            return
        pub_markers.publish(
            gripper_marker_array(out["grasps"], detector.gripper))
        n_pub = len(out["grasps"]) if publish_all else 1
        pub_grasps.publish(grasp_config_list_msg(
            out["grasps"][:n_pub], out["scores"][:n_pub]))
        rospy.loginfo("Published %d of %d ranked grasps",
                      n_pub, len(out["grasps"]))

    seed = frames = 0
    pending = None
    while not rospy.is_shutdown():
        if rospy.get_param("/robot_at_home") == "false":
            if pending is not None:
                detector.collect_frame(pending)   # stale: dropped
                pending = None
            rospy.loginfo("Robot is moving, waiting for it to go home.")
            rate.sleep()
            continue
        msg = rospy.wait_for_message(cloud_topic, PointCloud2)
        frames += 1
        if msg.data:
            points = pointcloud2_to_xyz_array(msg)
            if pipeline:
                nxt = detector.dispatch_frame(points, cam_pos, seed=seed)
                if pending is not None:
                    publish(detector.collect_frame(pending))
                pending = nxt
            else:
                publish(detector.process_frame(points, cam_pos, seed=seed))
            seed += 1
        else:
            rospy.loginfo("No points on the table, waiting...")
        if max_frames is not None and frames >= max_frames:
            break
        rate.sleep()
    if pending is not None:                       # drain the frame in flight
        publish(detector.collect_frame(pending))
