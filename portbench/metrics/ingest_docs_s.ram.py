"""Docs over the host seconds of the set-up's ``add_documents`` and
``flush`` calls on a ``ram`` directory."""


def read(run):
    if run.cfg["directory"] != "ram" or not run.ingest["seconds"]:
        return None
    return run.ingest["docs"] / run.ingest["seconds"]
