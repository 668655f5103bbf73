"""HDF5 schema key constants — storage-compatible with the reference's
databases (reference: dex-net/src/dexnet/database/keys.py).

The port's own copy of ``pointnetgpd_tpu/database/keys.py``: a database
written by either package opens in the other.
"""

METRICS_KEY = "metrics"
OBJECTS_KEY = "objects"
MESH_KEY = "mesh"
SDF_KEY = "sdf"
GRASPS_KEY = "grasps"
GRIPPERS_KEY = "grippers"
NUM_GRASPS_KEY = "num_grasps"
RENDERED_IMAGES_KEY = "rendered_images"
STP_KEY = "stable_poses"
CATEGORY_KEY = "category"
MASS_KEY = "mass"
CONVEX_PIECES_KEY = "convex_pieces"

CREATION_KEY = "time_created"
DATASETS_KEY = "datasets"

SDF_DATA_KEY = "data"
SDF_ORIGIN_KEY = "origin"
SDF_RES_KEY = "resolution"

MESH_VERTICES_KEY = "vertices"
MESH_TRIANGLES_KEY = "triangles"
MESH_DENSITY_KEY = "density"

NUM_STP_KEY = "num_stable_poses"
POSE_KEY = "pose"
STABLE_POSE_PROB_KEY = "p"
STABLE_POSE_ROT_KEY = "r"
STABLE_POSE_PT_KEY = "x0"

GRASP_KEY = "grasp"
GRASP_ID_KEY = "id"
GRASP_TYPE_KEY = "type"
GRASP_CONFIGURATION_KEY = "configuration"
GRASP_RF_KEY = "frame"
GRASP_TIMESTAMP_KEY = "timestamp"
GRASP_METRICS_KEY = "metrics"
