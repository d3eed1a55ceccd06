"""Storage substrate (port of ``repro/storage``): the device cost models
``SimClock`` charges and the persistent heap behind the byte path.

The paper's two access paths:

  - the **file path**: serialize -> syscall write -> fsync (Lucene's
    Directory over ext4, with or without DAX), ``core/directory.py``'s
    ``FSDirectory``;
  - the **byte path**: load/store directly into a ``PersistentHeap``
    (the paper's proposed future work), ``ByteAddressableDirectory``.

Inside the heap the byte path also keeps the write-ahead ingest log
(``wal.HeapWAL``: ack = one record + one barrier) and the live buffer index
(``live_index.LiveIndex``: the acked tail, searchable before a flush).
"""

from repro_torch.storage.device_model import DEVICE_MODELS, DRAM, PMEM, SSD, DeviceModel
from repro_torch.storage.heap import PersistentHeap

__all__ = [
    "DeviceModel",
    "SSD",
    "PMEM",
    "DRAM",
    "DEVICE_MODELS",
    "PersistentHeap",
]
