"""Device time of device-to-device copies per solve in the traced stretch,
in milliseconds."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if ctx.get("kind") != "solve" or not tr or not tr["units"] \
            or not tr["device_events"]:
        return None
    return tr["d2d_s"] * 1e3 / tr["units"]
