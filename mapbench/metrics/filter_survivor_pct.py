"""Filter survivors over seeded candidates (``MappingResult.stats``
``survivors`` / ``candidates``): the useful outcomes of the linear filter
over its attempts."""


def read(ctx):
    c = ctx["stats"]["candidates"]
    return 100.0 * ctx["stats"]["survivors"] / c if c else None
