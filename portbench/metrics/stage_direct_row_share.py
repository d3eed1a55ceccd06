"""The share of the query rows staged in the traced waves' ``stage`` spans
that took the card's direct route (``query_vectors``: rows of Python floats
written straight into a pinned buffer), in %: the spans' ``direct_rows``
over their ``rows``.  None where no span counts a row: a program without
the counts, or a cell with no vector or hybrid query."""

from portbench import program_spans


def read(run):
    trees = program_spans.traced_trees(run)
    if trees is None:
        return None
    rows = sum(trees.counts("stage", "rows"))
    if not rows:
        return None
    return 100.0 * sum(trees.counts("stage", "direct_rows")) / rows
