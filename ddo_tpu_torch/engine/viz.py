"""Graphviz export of a compiled decision diagram: counterpart of
`ddo_tpu/engine/viz.py`, over the port's `CompiledDD`, with the same text
for the same planes.

Counterpart of the reference's visualisation support (clean.rs:884-1090,
`VizConfig` + `as_graphviz`, demoed by examples/visualisation/main.rs):
renders nodes with value/locb/rub/theta labels, exact/relaxed/cutset
coloring, best-path highlighting, and a terminal sink node.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ddo_tpu_torch.utils.num import INF, NEG_INF


@dataclasses.dataclass
class VizConfig:
    """clean.rs:884-910 (defaults as in the reference).

    `show_deleted` divergence: the dense engine materializes layers as
    fixed-width tensors and restricted/merged-away candidates are never
    stored, so there are no deleted nodes to draw; the flag is accepted
    for API parity and ignored.  `group_merged` clusters each layer's
    *relaxed* (merged) nodes like the reference's purple clusters."""

    show_value: bool = True
    show_locb: bool = True
    show_rub: bool = True
    show_threshold: bool = True
    show_deleted: bool = False
    group_merged: bool = False


def _extreme(x):
    if x >= INF:
        return "+inf"
    if x <= NEG_INF:
        return "-inf"
    return str(int(x))


def as_graphviz(dd, config: VizConfig = None) -> str:
    """Renders a `CompiledDD` (engine/mdd.py) as a dot string."""
    config = config or VizConfig()
    o = dd.o
    n = dd.n
    W = o["mask"].shape[1]
    out = ["digraph {", "\tranksep = 3;", ""]

    def node_id(layer, slot):
        return layer * W + slot

    best_chain = set()
    if o["feasible"]:
        l, s = n, int(o["best_slot"])
        while l > int(o["root_depth"]) and s >= 0:
            best_chain.add((l, s))
            s = int(o["bp"][l, s])
            l -= 1
        best_chain.add((l, s))

    for layer in range(n + 1):
        for slot in range(W):
            if not o["mask"][layer, slot]:
                continue
            state = dd.node_state(layer, slot)
            label = ", ".join(
                f"{k}:{np.asarray(v).tolist()}" for k, v in sorted(state.items())
            ) if isinstance(state, dict) else str(state)
            if config.show_value:
                label += f"\\nval: {_extreme(o['value'][layer, slot])}"
            if config.show_locb:
                label += f"\\nlocb: {_extreme(o['value_bot'][layer, slot])}"
            if config.show_rub:
                label += f"\\nrub: {_extreme(o['rub'][layer, slot])}"
            if config.show_threshold:
                th = o["theta"][layer, slot] if o["has_theta"][layer, slot] else INF
                label += f"\\ntheta: {_extreme(th)}"
            if o["cutflag"][layer, slot]:
                color, peri = "red", 4
            elif o["exact"][layer, slot]:
                color, peri = '"#99ccff"', 1
            elif o["relaxed"][layer, slot]:
                color, peri = "yellow", 1
            else:
                color, peri = "lightgray", 1
            shape = "square" if o["relaxed"][layer, slot] else "circle"
            out.append(
                f"\t{node_id(layer, slot)} [shape={shape},style=filled,"
                f"color={color},peripheries={peri},label=\"{label}\"];"
            )

    # edges: the engine keeps best-in-edge pointers per node; draw those
    # (full [n, W, D] edge tensors are not fetched to the host by default)
    for layer in range(1, n + 1):
        for slot in range(W):
            if not o["mask"][layer, slot]:
                continue
            bp = int(o["bp"][layer, slot])
            if bp >= 0 and o["mask"][layer - 1, bp]:
                width = 3 if (layer, slot) in best_chain and (layer - 1, bp) in best_chain else 1
                var = int(o["var_of"][layer - 1])
                val = int(o["bd"][layer, slot])
                out.append(
                    f"\t{node_id(layer - 1, bp)} -> {node_id(layer, slot)} "
                    f"[penwidth={width},label=\"(x{var} = {val})\"];"
                )

    # merged-node clusters (clean.rs:934-954)
    if config.group_merged:
        for layer in range(n + 1):
            merged = [
                str(node_id(layer, s))
                for s in range(W)
                if o["mask"][layer, s] and o["relaxed"][layer, s]
            ]
            if merged:
                out.append(f"\tsubgraph cluster_{layer} {{")
                out.append("\t\tstyle=filled;")
                out.append("\t\tcolor=purple;")
                out.append(f"\t\t{';'.join(merged)}")
                out.append("\t};")

    # terminal sink (clean.rs:982-1001)
    term = [s for s in range(W) if o["mask"][n, s]]
    if term:
        out.append(
            '\tterminal [shape="circle", label="", style="filled", color="black"];'
        )
        vmax = max(int(o["value"][n, s]) for s in term)
        for s in term:
            pen = 3 if int(o["value"][n, s]) == vmax else 1
            out.append(f"\t{node_id(n, s)} -> terminal [penwidth={pen}];")
    out.append("}")
    return "\n".join(out)
