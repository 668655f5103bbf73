"""HDF5 object/grasp database (reference: dex-net/src/dexnet/database/)."""

from .hdf5 import READ_ONLY_ACCESS, READ_WRITE_ACCESS, Hdf5Database, Hdf5Dataset
from .mesh_processor import MeshProcessor, RescalingType

__all__ = ["Hdf5Database", "Hdf5Dataset", "MeshProcessor", "RescalingType",
           "READ_ONLY_ACCESS", "READ_WRITE_ACCESS"]
