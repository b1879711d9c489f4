"""Seconds per scene that rank 0's host spent inside the mesh's collective
calls during expansion: the program's counter `overhead_collective_s`
(`parallel/multihost.py::_Overhead`, the host clock around each
`parallel/mesh.py` collective: the Nelder-Mead exit flags, the refine
all-gathers, the occupancy vote), summed over the window's scenes. Only
rank 0 reports it; a run on one card has no such counter."""
UNIT = "s"


def read(ctx):
    s = ctx.counters.get("overhead_collective_s")
    return None if s is None else s / ctx.scenes
