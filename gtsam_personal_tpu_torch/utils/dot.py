"""Graphviz export of factor graphs (reference: inference/DotWriter.h,
nonlinear/GraphvizFormatting.h).

JAX counterpart: gtsam_personal_tpu/utils/dot.py (all of it). One host
copy of each batch's index tensor.
"""

from gtsam_personal_tpu_torch.core.graph import FactorGraph


def to_dot(graph: FactorGraph, name: str = "factor_graph") -> str:
    lines = [f"graph {name} {{", "  node [shape=circle];"]
    fid = 0
    seen_vars = set()
    for b in graph.batches:
        idx = b.idx.cpu().numpy()
        for k in range(idx.shape[0]):
            fnode = f"f{fid}"
            lines.append(f'  {fnode} [shape=point, label="", xlabel="{b.name}"];')
            for s, g in enumerate(b.groups):
                v = f"{g}{idx[k, s]}"
                if v not in seen_vars:
                    lines.append(f'  {v} [label="{v}"];')
                    seen_vars.add(v)
                lines.append(f"  {fnode} -- {v};")
            fid += 1
    lines.append("}")
    return "\n".join(lines)


def write_dot(graph: FactorGraph, path: str, name: str = "factor_graph"):
    with open(path, "w") as f:
        f.write(to_dot(graph, name))
