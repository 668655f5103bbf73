"""File-name and database-access constants (reference:
dex-net/src/dexnet/constants.py:22-43; the port's copy of the entries of
``pointnetgpd_tpu/constants.py`` that it uses). The strings name files in
processed-mesh caches and access levels of the HDF5 database, so they match
the reference."""

OBJ_EXT = ".obj"
OFF_EXT = ".off"
SDF_EXT = ".sdf"

PROC_TAG = "_proc"

# database access levels
READ_ONLY_ACCESS = "READ_ONLY"
READ_WRITE_ACCESS = "READ_WRITE"
