"""Process start to the first timed call: corpus, ingest, reopen, warm-up."""


def read(run):
    return run.setup_s
