"""The share of the traced stretch of solves in which no operation ran on
the device, in percent."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "solve" or not tr or tr["idle_share"] is None:
        return None
    return 100.0 * tr["idle_share"]
