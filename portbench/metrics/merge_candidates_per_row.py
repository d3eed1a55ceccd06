"""The mean merged width C of the ``(B, C)`` candidates over the traced
waves' ``merge`` spans: the candidates each row's cross-segment merge
sorts."""

from portbench import program_spans


def read(run):
    trees = program_spans.traced_trees(run)
    if trees is None:
        return None
    widths = trees.counts("merge", "candidates")
    return sum(widths) / len(widths) if widths else None
