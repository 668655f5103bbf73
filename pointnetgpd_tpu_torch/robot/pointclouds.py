"""sensor_msgs/PointCloud2 <-> numpy converters (host-side).

Re-implementation of the reference helpers (reference:
dex-net/apps/pointclouds.py:68-244) without importing ROS at module load:
the functions operate on any object with PointCloud2's duck-typed fields
(``fields``, ``point_step``, ``row_step``, ``width``, ``height``, ``data``,
``is_bigendian``), so they are testable without a ROS install and work with
rospy messages when present.

A copy of ``pointnetgpd_tpu/robot/pointclouds.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

# PointField datatype codes (sensor_msgs/PointField)
_DATATYPES = {
    1: ("i1", 1), 2: ("u1", 1), 3: ("i2", 2), 4: ("u2", 2),
    5: ("i4", 4), 6: ("u4", 4), 7: ("f4", 4), 8: ("f8", 8),
}


def pointcloud2_to_dtype(msg):
    """Build a numpy structured dtype from the message fields
    (pointclouds.py:68-102 semantics, incl. gap padding)."""
    offset = 0
    names, formats, offsets = [], [], []
    for f in msg.fields:
        code, size = _DATATYPES[f.datatype]
        names.append(f.name)
        formats.append(("<" if not msg.is_bigendian else ">") + code)
        offsets.append(f.offset)
        offset = max(offset, f.offset + size * max(f.count, 1))
    return np.dtype({"names": names, "formats": formats, "offsets": offsets,
                     "itemsize": msg.point_step})


def pointcloud2_to_array(msg):
    """PointCloud2 -> structured array (pointclouds.py:105-133)."""
    dtype = pointcloud2_to_dtype(msg)
    arr = np.frombuffer(bytes(msg.data), dtype=dtype,
                        count=msg.width * msg.height)
    if msg.height > 1:
        return arr.reshape(msg.height, msg.width)
    return arr


def get_xyz_points(cloud_array, remove_nans: bool = True, dtype=np.float32):
    """Structured array -> (N, 3) xyz (pointclouds.py:199-223)."""
    if remove_nans:
        mask = (np.isfinite(cloud_array["x"]) & np.isfinite(cloud_array["y"])
                & np.isfinite(cloud_array["z"]))
        cloud_array = cloud_array[mask]
    points = np.zeros(cloud_array.shape + (3,), dtype=dtype)
    points[..., 0] = cloud_array["x"]
    points[..., 1] = cloud_array["y"]
    points[..., 2] = cloud_array["z"]
    return points


def pointcloud2_to_xyz_array(msg, remove_nans: bool = True):
    """(pointclouds.py:226-244)."""
    return get_xyz_points(pointcloud2_to_array(msg), remove_nans)


def xyz_array_to_pointcloud2(points, stamp=None, frame_id=None):
    """(N, 3) -> PointCloud2 message (requires ROS; pointclouds.py:137-196)."""
    from sensor_msgs.msg import PointCloud2, PointField  # gated import

    msg = PointCloud2()
    if stamp is not None:
        msg.header.stamp = stamp
    if frame_id is not None:
        msg.header.frame_id = frame_id
    msg.height = 1
    msg.width = len(points)
    msg.fields = [
        PointField(name=n, offset=4 * i, datatype=7, count=1)
        for i, n in enumerate("xyz")
    ]
    msg.is_bigendian = False
    msg.point_step = 12
    msg.row_step = 12 * len(points)
    msg.is_dense = True
    msg.data = np.asarray(points, np.float32).tobytes()
    return msg
