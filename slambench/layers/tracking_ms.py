"""Host ms a window frame spends in the `tracking` stage (System.metrics)."""


def read(ctx):
    ms = ctx["stages"].get("tracking")
    return None if ms is None else ms / ctx["frames"]
