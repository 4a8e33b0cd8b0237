"""CUDA-graph replays a predicted batch: the count of the program's
``mc_graph.replay`` spans in a traced ``mc_forward`` unit, 0 in a unit
with none (a batch run eager), the median over the traced units
(``perfbench/spans.py``). 1 where every batch is one replay of its
captured MC batch; None where the program has no spans."""

from perfbench import spans


def read(ctx):
    return spans.median(ctx, "predict", lambda u: u["spans"].get(
        "mc_graph.replay", {}).get("count", 0))
