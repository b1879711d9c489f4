"""Share of Nelder-Mead's solves on the card that replayed a CUDA graph an
earlier solve had captured, over the window's scenes: the program's
counters `nm_graph_reuses` over `nm_graph_reuses` + `nm_graph_captures`
(`ops/simplex.py`). None where the program counts no reuse (a program
that captures a graph per solve) or no graph was made."""
UNIT = "fraction"


def read(ctx):
    reuses = ctx.counters.get("nm_graph_reuses")
    captures = ctx.counters.get("nm_graph_captures")
    if reuses is None or captures is None or not reuses + captures:
        return None
    return reuses / (reuses + captures)
