"""ROS message construction for the online node (gated imports).

Equivalent of the reference's marker/grasp message assembly
(reference: dex-net/apps/kinect2grasp.py:261-376 show_marker /
show_grasp_marker / get_grasp_msg): gripper visualization as cube markers in
the grasp frame and GraspConfig messages carrying the frame vectors.

A copy of ``pointnetgpd_tpu/robot/ros_messages.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np


def _quaternion_from_matrix(rot):
    """Rotation matrix -> (w, x, y, z) quaternion."""
    m = np.asarray(rot, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([0.25 / s, (m[2, 1] - m[1, 2]) * s,
                         (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s])
    i = np.argmax(np.diag(m))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def gripper_marker_array(grasps, gripper, frame_id: str = "/table_top",
                         color=(0, 1, 0), lifetime: float = 8.0):
    """MarkerArray of cube markers for each grasp's two fingers + palm
    (kinect2grasp.py:288-376 geometry)."""
    from visualization_msgs.msg import Marker, MarkerArray

    import rospy

    arr = MarkerArray()
    marker_id = 0
    hh, fw, hd = gripper.hand_height, gripper.finger_width, gripper.hand_depth
    open_w = gripper.open_width
    for g in np.asarray(grasps):
        bottom, approach, binormal, minor = g[0], g[1], g[2], g[3]
        rot = np.stack([approach, binormal, minor], axis=1)
        quat = _quaternion_from_matrix(rot)
        # palm + two fingers as cubes in the grasp frame
        parts = [
            (bottom - approach * hh / 2, [hh, open_w + 2 * fw, hh]),   # palm
            (bottom + approach * hd / 2 - binormal * (open_w + fw) / 2,
             [hd, fw, hh]),                                            # left
            (bottom + approach * hd / 2 + binormal * (open_w + fw) / 2,
             [hd, fw, hh]),                                            # right
        ]
        for pos, scale in parts:
            m = Marker()
            m.header.frame_id = frame_id
            m.type = Marker.CUBE
            m.action = Marker.ADD
            m.id = marker_id
            marker_id += 1
            m.pose.position.x, m.pose.position.y, m.pose.position.z = pos
            (m.pose.orientation.w, m.pose.orientation.x,
             m.pose.orientation.y, m.pose.orientation.z) = quat
            m.scale.x, m.scale.y, m.scale.z = scale
            m.color.a = 0.5
            m.color.r, m.color.g, m.color.b = color
            m.lifetime = rospy.Duration.from_sec(lifetime)
            arr.markers.append(m)
    return arr


def grasp_config_list_msg(grasps, scores, frame_id: str = "/table_top"):
    """GraspConfigList from ranked grasp frames (kinect2grasp.py:516-544;
    gpd_grasp_msgs message layout: bottom/approach/binormal/axis + score)."""
    import rospy
    from gpd_grasp_msgs.msg import GraspConfig, GraspConfigList

    out = GraspConfigList()
    out.header.stamp = rospy.Time.now()
    out.header.frame_id = frame_id
    for g, s in zip(np.asarray(grasps), np.asarray(scores)):
        msg = GraspConfig()
        msg.bottom.x, msg.bottom.y, msg.bottom.z = g[4]  # modified center
        msg.approach.x, msg.approach.y, msg.approach.z = g[1]
        msg.binormal.x, msg.binormal.y, msg.binormal.z = g[2]
        msg.axis.x, msg.axis.y, msg.axis.z = g[3]
        msg.score.data = float(s)
        out.grasps.append(msg)
    return out
