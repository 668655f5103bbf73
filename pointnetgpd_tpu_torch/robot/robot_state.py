"""Robot-at-home state publisher.

(reference: dex-net/apps/get_ur5_robot_state.py:12-41 — polls MoveIt joint
states at 10 Hz and publishes the ``/robot_at_home`` ROS param that gates the
grasp sampler.) ROS/MoveIt imports are gated; the home-detection predicate is
pure and testable.

A copy of ``pointnetgpd_tpu/robot/robot_state.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

# UR5 home joint configuration (radians) — the reference compares the live
# joint values against the robot's parked pose with a small tolerance.
DEFAULT_HOME = np.array([0.0, -1.5708, 0.0, -1.5708, 0.0, 0.0])


def at_home(joint_values, home=DEFAULT_HOME, tol: float = 0.01) -> bool:
    """True when all joints are within ``tol`` radians of the home pose."""
    joint_values = np.asarray(joint_values, float)
    return bool(np.all(np.abs(joint_values - np.asarray(home)) < tol))


def run_state_publisher(group_name: str = "manipulator",
                        home=DEFAULT_HOME, tol: float = 0.01,
                        rate_hz: float = 10.0):
    """ROS node: publish /robot_at_home from MoveIt joint states
    (get_ur5_robot_state.py:12-41)."""
    import moveit_commander
    import rospy

    rospy.init_node("robot_state_publisher", anonymous=True)
    group = moveit_commander.MoveGroupCommander(group_name)
    rate = rospy.Rate(rate_hz)
    while not rospy.is_shutdown():
        joints = group.get_current_joint_values()
        rospy.set_param("/robot_at_home",
                        "true" if at_home(joints, home, tol) else "false")
        rate.sleep()


if __name__ == "__main__":
    run_state_publisher()
