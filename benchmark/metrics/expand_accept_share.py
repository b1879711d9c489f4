"""Share of expansion's candidates that were accepted, over the rounds of
the window's scenes: the program's counters `expand_accepted` over
`expand_candidates` (`pmvs/expand.py`; the candidates Nelder-Mead
refined, after any pre-screen)."""
UNIT = "fraction"


def read(ctx):
    tried = ctx.counters.get("expand_candidates")
    accepted = ctx.counters.get("expand_accepted")
    if not tried or accepted is None:
        return None
    return accepted / tried
