"""Docs over the host seconds of the set-up's acked ``add_documents`` and
``flush`` calls through the write-ahead log on the byte path."""


def read(run):
    if not run.cfg["use_wal"] or not run.cfg["directory"].startswith("byte") \
            or not run.ingest["seconds"]:
        return None
    return run.ingest["docs"] / run.ingest["seconds"]
