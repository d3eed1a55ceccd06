"""Core of the port: ingest, segments, lifecycle, directories, writer, query
execution, searcher, NRT manager and engine (mirrors ``repro/core``), with
the reference's exports apart from sharding (ROADMAP queue 1, item 12)."""

from repro_torch.core.analyzer import Analyzer, term_hash
from repro_torch.core.columnar import ColumnarBuffer
from repro_torch.core.segment import (
    Segment,
    build_segment,
    build_segment_columnar,
    build_segment_reference,
    merge_segments,
    merge_segments_reference,
)
from repro_torch.core.directory import (
    ByteAddressableDirectory,
    Directory,
    FSDirectory,
    RAMDirectory,
    SimClock,
)
from repro_torch.core.writer import IndexWriter
from repro_torch.core.query.cache import CacheStats, SegmentDeviceCache
from repro_torch.core.search import Searcher
from repro_torch.core.query.types import TopDocs
from repro_torch.core.nrt import SearcherManager
from repro_torch.core.engine import SearchEngine

__all__ = [
    "CacheStats",
    "SegmentDeviceCache",
    "Analyzer",
    "term_hash",
    "Segment",
    "ColumnarBuffer",
    "build_segment",
    "build_segment_columnar",
    "build_segment_reference",
    "merge_segments",
    "merge_segments_reference",
    "Directory",
    "FSDirectory",
    "ByteAddressableDirectory",
    "RAMDirectory",
    "SimClock",
    "IndexWriter",
    "Searcher",
    "TopDocs",
    "SearcherManager",
    "SearchEngine",
]
