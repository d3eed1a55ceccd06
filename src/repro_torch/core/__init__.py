"""Core of the port: ingest, segments, lifecycle, directory, writer, query
execution, searcher, NRT manager and engine (mirrors ``repro/core``).

Kept import-light: modules are imported where they are used."""
