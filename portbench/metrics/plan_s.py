"""Host seconds of the graph layer: graph, fusion, parameter migration,
schedule and render plan (and the trainer's construction), by the
benchmark's clock around those calls."""


def read(name, ctx):
    return ctx.spans.get("plan_s")
