"""The whole solve's share of its frozen bound (``bench/count.py``): the
bound over the window's time per solve, in percent."""


def read(ctx: dict):
    if ctx.get("kind") != "solve" or not ctx.get("solve_ms"):
        return None
    return 100.0 * ctx["bound_s"] * 1e3 / ctx["solve_ms"]
