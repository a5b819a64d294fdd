"""Graph compile (graph/compiler.py): the program's counters, template builds over template lookups, %."""

from portbench.layers.program import counter


def read(trace):
    lookups, builds = counter("graph_template_lookups"), counter("graph_template_builds")
    if not lookups:
        return None
    return 100.0 * (builds or 0) / lookups
