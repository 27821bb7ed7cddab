"""The share of the client slots the traced rounds computed that train:
100 x the clients the participation masks released over the clients
computed, summed over the rounds' ``round.block`` spans (their
``released`` and ``clients``, engine/fedcore.py). Offline clients are
computed and then masked; this is what training only the online cohort
would save."""

from benchmark.spans import under


def read(ctx):
    blocks = under(ctx, "train", "round.block")
    if not blocks or any("released" not in b.attrs for b in blocks):
        return None
    return 100.0 * sum(b.attrs["released"] for b in blocks) / sum(
        b.attrs["clients"] for b in blocks)
