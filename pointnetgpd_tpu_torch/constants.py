"""File-name constants of the object-preparation path (reference:
dex-net/src/dexnet/constants.py:22-43; the port's copy of the entries of
``pointnetgpd_tpu/constants.py`` that it uses). The strings name files in
processed-mesh caches, so they match the reference."""

OBJ_EXT = ".obj"
OFF_EXT = ".off"
SDF_EXT = ".sdf"

PROC_TAG = "_proc"
