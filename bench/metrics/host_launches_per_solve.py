"""Host calls that put work on the device (kernel, graph and copy launches,
as ``bench/devtrace.py`` counts them) per solve in the traced stretch."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "solve" or not tr or not tr["units"] \
            or not tr["device_events"]:
        return None
    return tr["launches"] / tr["units"]
