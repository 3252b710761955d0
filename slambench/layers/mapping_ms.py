"""Host ms a window frame spends in local mapping: the stages
`mapping_stage` and `mapping_catchup` of System.metrics."""


def read(ctx):
    parts = [ctx["stages"][k] for k in ("mapping_stage", "mapping_catchup") if k in ctx["stages"]]
    return sum(parts) / ctx["frames"] if parts else None
