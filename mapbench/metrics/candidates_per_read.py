"""Seeded candidates (valid placements of both strands' encodings,
``MappingResult.stats`` ``candidates``) per read handed to the entry."""


def read(ctx):
    n = ctx["stats"]["reads"]
    return ctx["stats"]["candidates"] / n if n else None
