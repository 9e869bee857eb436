"""Time of one merged KB call: the retriever's own ledger
(``RetrieverStats.time / calls``, host clock around each call, transfers
included) over the window."""
LAYER = "retrieval"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    w = run.window
    return 1000.0 * w.kb_time / w.kb_calls if w.kb_calls else None
