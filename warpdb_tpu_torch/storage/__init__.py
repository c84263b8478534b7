"""Device storage of the port.  The host side (``HostTable``,
``DataType``, ``load_table``) is ``warpdb_tpu.storage``'s, re-exported."""

from warpdb_tpu.storage import DataType, HostTable, load_table

from .table import DeviceTable

__all__ = ["DeviceTable", "DataType", "HostTable", "load_table"]
