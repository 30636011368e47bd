"""The sum over sp's own time a traced frame, in ms: for each collective,
the NCCL kernel's device time on the rank that reached it last, the
least over the ranks (the ranks run the same collectives in the same
order). Every other rank's kernel also holds its wait for that rank, so
the ranks' own totals (the run's `extra.nccl_ms_per_rank`) measure the
skew between ranks, not the exchange."""


def read(ctx):
    per_rank = ctx.get("nccl_us")
    if not per_rank or not all(per_rank):
        return None
    return sum(min(d) for d in zip(*per_rank)) * 1e-3 / ctx["units"]
