"""Static checks of a graph configuration (the JAX package's
``analysis/graphcheck.py``), kept as the port's own copy. So far the one
the pipeline needs: :func:`graph_cut_points`, the single-tensor stage
boundaries of a DAG that ``parallel/pipeline.GraphPipelineTrainer``
partitions at."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def graph_cut_points(conf, order: Optional[List[str]] = None
                     ) -> List[Tuple[int, str]]:
    """Valid single-tensor pipeline stage boundaries of a DAG: positions
    ``p`` in the topological order where exactly ONE node's activation
    crosses from the prefix ``topo[:p]`` to the suffix, the single tensor
    a pipeline stage hands the next. Returns [(p, crossing_node_name)].
    A residual/skip connection spanning a candidate boundary (e.g. a
    transformer block's residual stream around its attention sublayer)
    disqualifies it: two tensors would cross. An output node counts as
    crossing to the end, so no cut strands a head's input."""
    topo = list(order if order is not None
                else conf.topological_order or conf.nodes)
    consumers: Dict[str, List[str]] = {n: [] for n in topo}
    for n in topo:
        for i in conf.nodes[n].inputs:
            if i in consumers:   # dangling references are not this check's
                consumers[i].append(n)
    out_set = set(conf.network_outputs)
    cuts: List[Tuple[int, str]] = []
    prefix: set = set()
    crossing: set = set()
    for p, n in enumerate(topo):
        prefix.add(n)
        crossing.add(n)
        crossing = {m for m in crossing
                    if m in out_set
                    or any(c not in prefix for c in consumers[m])}
        if len(crossing) == 1:
            cuts.append((p + 1, next(iter(crossing))))
    return cuts
