"""The frozen bound over the device's busy time per solve in the traced
stretch (the union of its operations' intervals), in percent."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "solve" or not tr or not tr["busy_s"] \
            or not tr["units"]:
        return None
    return 100.0 * ctx["bound_s"] / (tr["busy_s"] / tr["units"])
